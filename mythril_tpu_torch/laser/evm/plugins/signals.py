"""Plugin flow-control signals (reference surface:
mythril/laser/ethereum/plugins/signals.py)."""


class PluginSignal(Exception):
    """Base plugin signal."""


class PluginSkipWorldState(PluginSignal):
    """Skip adding this world state to the open states."""


class PluginSkipState(PluginSignal):
    """Skip executing this state."""
