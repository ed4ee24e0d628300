"""Hook wiring for detection modules.

Parity surface: mythril/analysis/module/util.py — expands each module's
pre/post hook declarations (opcode names, or prefix wildcards such as
"PUSH*") into the {opcode: [callbacks]} dict the engine consumes."""

import logging
from typing import Callable, Dict, List, Optional

from mythril_tpu_torch.analysis.module import gating
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.support.opcodes import NAME_SPECS

log = logging.getLogger(__name__)

_ALL_OPCODES = tuple(NAME_SPECS.keys())


def _expand(pattern: str) -> List[str]:
    """An opcode name, or a 'PREFIX*' wildcard, to concrete opcode names."""
    pattern = pattern.upper()
    if pattern in NAME_SPECS:
        return [pattern]
    if pattern.endswith("*"):
        prefix = pattern[:-1]
        return [name for name in _ALL_OPCODES if name.startswith(prefix)]
    return []


def get_detection_module_hooks(
    modules: List[DetectionModule], hook_type: str = "pre"
) -> Dict[str, List[Callable]]:
    hooks: Dict[str, List[Callable]] = {}
    for module in modules:
        declared = module.pre_hooks if hook_type == "pre" else module.post_hooks
        # pre-hooks dispatch through the static-fact gate (gating.py):
        # statically irrelevant pcs are skipped, everything else (and
        # every post-hook) runs unchanged
        callback = (
            gating.wrap_pre_hook(module)
            if hook_type == "pre"
            else module.execute
        )
        for pattern in declared:
            expanded = _expand(pattern)
            if not expanded:
                log.error(
                    "Encountered invalid hook opcode %s in module %s",
                    pattern,
                    module.name,
                )
            for opcode in expanded:
                hooks.setdefault(opcode, []).append(callback)
    return hooks


def reset_callback_modules(module_names: Optional[List[str]] = None) -> None:
    """Clean the issue records of every callback-based module."""
    for module in ModuleLoader().get_detection_modules(
        EntryPoint.CALLBACK, module_names
    ):
        module.reset_module()
