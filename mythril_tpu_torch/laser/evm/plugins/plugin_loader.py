"""Laser plugin loader (reference surface:
mythril/laser/ethereum/plugins/plugin_loader.py)."""

import logging
from typing import List

from mythril_tpu_torch.laser.evm.plugins.plugin import LaserPlugin

log = logging.getLogger(__name__)


class LaserPluginLoader:
    """Abstracts plugin loading for the symbolic vm."""

    def __init__(self, symbolic_vm) -> None:
        self.symbolic_vm = symbolic_vm
        self.laser_plugins: List[LaserPlugin] = []

    def load(self, laser_plugin: LaserPlugin) -> None:
        log.info("Loading plugin: %s", str(laser_plugin))
        laser_plugin.initialize(self.symbolic_vm)
        self.laser_plugins.append(laser_plugin)

    def is_enabled(self, laser_plugin: LaserPlugin) -> bool:
        return laser_plugin in self.laser_plugins
