"""Annotations shared by the built-in laser plugins.

Parity surface:
mythril/laser/ethereum/plugins/implementations/plugin_annotations.py."""

from copy import copy
from typing import Dict, List, Set

from mythril_tpu_torch.laser.evm.state.annotation import StateAnnotation


def slot_key(slot):
    """Structural identity key for a storage slot: hash-consed term uid
    for symbolic values, the value itself for concrete ones. List
    membership via ``BitVec.__eq__`` builds a symbolic Bool TERM per
    probe — keyed dicts keep footprint bookkeeping O(1) per access."""
    raw = getattr(slot, "raw", None)
    if raw is not None:
        return ("t", raw.uid)
    return ("c", slot)


class MutationAnnotation(StateAnnotation):
    """The path executed a state-mutating instruction (mutation pruner)."""

    @property
    def persist_over_calls(self) -> bool:
        return True


class DependencyAnnotation(StateAnnotation):
    """Read/write footprint of the current path (dependency pruner).

    ``storage_loaded`` and the per-iteration write caches are dicts
    keyed by :func:`slot_key` (insertion-ordered; values are the slot
    terms) so dedup never constructs symbolic comparison terms."""

    __slots__ = ("storage_loaded", "storage_written", "has_call", "path", "blocks_seen")

    def __init__(self):
        self.storage_loaded: Dict = {}
        self.storage_written: Dict[int, Dict] = {}
        self.has_call: bool = False
        self.path: List[int] = [0]
        self.blocks_seen: Set[int] = set()

    def __copy__(self):
        clone = DependencyAnnotation()
        clone.storage_loaded = copy(self.storage_loaded)
        # SHALLOW copy: the per-iteration inner containers stay shared
        # between forked siblings exactly as in the reference
        # (plugin_annotations.py:33 copies the outer dict only), so a
        # sibling's SSTORE stays visible in the other's write cache and
        # pruning remains as conservative as upstream
        clone.storage_written = copy(self.storage_written)
        clone.has_call = self.has_call
        clone.path = copy(self.path)
        clone.blocks_seen = copy(self.blocks_seen)
        return clone

    def get_storage_write_cache(self, iteration: int):
        return list(self.storage_written.get(iteration, {}).values())

    def extend_storage_write_cache(self, iteration: int, value):
        cache = self.storage_written.setdefault(iteration, {})
        cache.setdefault(slot_key(value), value)


class WSDependencyAnnotation(StateAnnotation):
    """Stack of per-transaction dependency annotations riding the world
    state between transactions."""

    __slots__ = ("annotations_stack",)

    def __init__(self):
        self.annotations_stack: List = []

    def __copy__(self):
        clone = WSDependencyAnnotation()
        clone.annotations_stack = copy(self.annotations_stack)
        return clone
