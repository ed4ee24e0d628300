"""Dependency pruner.

Parity surface:
mythril/laser/ethereum/plugins/implementations/dependency_pruner.py.

The observation: from the second transaction on, re-exploring a basic
block can only produce new behavior if some SLOAD in it may alias a slot
written by the PREVIOUS transaction. The plugin builds a per-block access
index (which slots paths through each block load/store, whether they
call out), carries each path's write set across transactions on a
world-state annotation stack, and skips repeat block entries whose reads
provably cannot alias last round's writes.
"""

import logging
from typing import Dict, List, Set

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.evm.plugins.implementations.plugin_annotations import (
    DependencyAnnotation,
    WSDependencyAnnotation,
    slot_key,
)
from mythril_tpu_torch.laser.evm.plugins.plugin import LaserPlugin
from mythril_tpu_torch.laser.evm.plugins.signals import PluginSkipState
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState
from mythril_tpu_torch.laser.evm.transaction.transaction_models import (
    ContractCreationTransaction,
)

log = logging.getLogger(__name__)


def _may_equal(lhs, rhs) -> bool:
    """Satisfiability of lhs == rhs (a cheap alias check)."""
    try:
        solver.get_model((lhs == rhs,))
        return True
    except UnsatError:
        return False


def path_annotation(state: GlobalState) -> DependencyAnnotation:
    """This path's annotation; a fresh transaction inherits the previous
    transaction's annotation from the world-state stack."""
    for annotation in state.get_annotations(DependencyAnnotation):
        return annotation
    try:
        annotation = world_annotation(state).annotations_stack.pop()
    except IndexError:
        annotation = DependencyAnnotation()
    state.annotate(annotation)
    return annotation


def world_annotation(state: GlobalState) -> WSDependencyAnnotation:
    for annotation in state.world_state.get_annotations(WSDependencyAnnotation):
        return annotation
    annotation = WSDependencyAnnotation()
    state.world_state.annotate(annotation)
    return annotation


class BlockAccessIndex:
    """What paths through each basic block (keyed by block address) do.

    Slot membership is keyed by STRUCTURAL identity (hash-consed term
    uid for symbolic slots, the value for concrete ones). The list
    version's ``slot not in slots`` probed with ``BitVec.__eq__`` —
    which constructs a symbolic Bool TERM per comparison — and at lift
    time (every device storage event replays through record_load/store
    over the whole recorded path) that was 3M+ term constructions and
    ~1/3 of BECToken's analysis wall."""

    def __init__(self):
        # block -> {slot key: slot term}; dict preserves recording order
        self.loads: Dict[int, Dict[object, object]] = {}
        self.stores: Dict[int, Dict[object, object]] = {}
        self.calls: Dict[int, bool] = {}
        self.all_loaded_slots: Set = set()  # slot KEYS (see slot_key)

    @staticmethod
    def _record(
        table: Dict[int, Dict[object, object]], path, key, slot
    ) -> None:
        for block in path:
            table.setdefault(block, {}).setdefault(key, slot)

    def record_load(self, path: List[int], slot) -> None:
        key = slot_key(slot)  # once per event: this is the replay hot path
        self._record(self.loads, path, key, slot)
        self.all_loaded_slots.add(key)

    def record_store(self, path: List[int], slot) -> None:
        self._record(self.stores, path, slot_key(slot), slot)

    def record_call(self, path: List[int]) -> None:
        for block in path:
            if block in self.stores:
                self.calls[block] = True


class DependencyPruner(LaserPlugin):
    """Skips repeat block entries that cannot observe last round's writes.

    Batch-aware: every hook below is marked for device replay
    (tape_replay_safe), so under tpu-batch the branches and storage ops
    it watches retire on device and the bridge re-fires the hooks at
    lift time — SLOAD/SSTORE from the tape/event ring, block entries
    from the jumpdest ring plus symbolic-branch fall-through sites. A
    device segment whose jumpdest ring overflowed cannot reconstruct
    its full path, so pruning disables itself for the rest of the run
    (sound: pruning off = reference behavior without the plugin)."""

    def __init__(self):
        self._reset()

    def _reset(self):
        self.iteration = 0
        self.index = BlockAccessIndex()
        self.pruning_enabled = True

    # -- pruning decision ----------------------------------------------------

    def wanna_execute(self, block: int, annotation: DependencyAnnotation) -> bool:
        if not self.pruning_enabled:
            return True
        if block in self.index.calls:
            return True  # calls have unknowable effects; never prune
        block_reads = self.index.loads.get(block)
        if block_reads is None:
            return False  # pure block: provably nothing to observe

        if ("c", block) in self.index.all_loaded_slots:
            # (reference behavior) a block address doubling as an accessed
            # slot defeats the separation; bail to execution when any
            # stored block may alias it
            for stored_block in self.index.stores:
                if _may_equal(stored_block, block):
                    return True

        last_writes = annotation.get_storage_write_cache(self.iteration - 1)
        observable = list(block_reads.values()) + list(
            annotation.storage_loaded.values()
        )
        for written_slot in last_writes:
            if any(_may_equal(written_slot, read) for read in observable):
                return True
        return False

    # -- hook wiring ---------------------------------------------------------

    def initialize(self, symbolic_vm) -> None:
        self._reset()

        def on_block_entry(state: GlobalState) -> None:
            block = state.get_current_instruction()["address"]
            annotation = path_annotation(state)
            annotation.path.append(block)
            if self.iteration < 2:
                return
            if block not in annotation.blocks_seen:
                annotation.blocks_seen.add(block)
                return
            if not self.wanna_execute(block, annotation):
                log.debug(
                    "Pruning block %d: reads cannot alias tx-%d writes",
                    block,
                    self.iteration - 1,
                )
                raise PluginSkipState

        def on_transaction_end(state: GlobalState) -> None:
            annotation = path_annotation(state)
            for slot in annotation.storage_loaded.values():
                self.index.record_load(annotation.path, slot)
            # iterates the OUTER per-iteration dict — i.e. iteration
            # numbers, not slots — mirroring the reference exactly
            # (reference dependency_pruner.py:275 does the same; real
            # written slots are recorded by sstore_hook at fire time)
            for slot in annotation.storage_written:
                self.index.record_store(annotation.path, slot)
            if annotation.has_call:
                self.index.record_call(annotation.path)

        def on_device_overflow() -> None:
            if self.pruning_enabled:
                self.pruning_enabled = False
                log.info(
                    "a device segment's jumpdest ring overflowed; "
                    "dependency pruning disabled for the rest of the run"
                )

        # device-replay contract: safe to re-fire these at synthesized
        # sites (annotation/index bookkeeping over [slot]/[value, key]
        # stack shims); the block-entry hook may raise PluginSkipState,
        # which the backend maps to dropping the lifted state
        on_block_entry.tape_replay_safe = True
        on_block_entry.on_device_overflow = on_device_overflow

        @symbolic_vm.laser_hook("start_sym_trans")
        def start_sym_trans_hook():
            self.iteration += 1

        for jump_op in ("JUMP", "JUMPI"):
            symbolic_vm.post_hook(jump_op)(on_block_entry)

        @symbolic_vm.pre_hook("SSTORE")
        def sstore_hook(state: GlobalState):
            annotation = path_annotation(state)
            slot = state.mstate.stack[-1]
            self.index.record_store(annotation.path, slot)
            annotation.extend_storage_write_cache(self.iteration, slot)

        sstore_hook.tape_replay_safe = True

        @symbolic_vm.pre_hook("SLOAD")
        def sload_hook(state: GlobalState):
            annotation = path_annotation(state)
            slot = state.mstate.stack[-1]
            annotation.storage_loaded.setdefault(slot_key(slot), slot)
            # record against the whole path so far: execution may never
            # reach a clean transaction end
            self.index.record_load(annotation.path, slot)

        sload_hook.tape_replay_safe = True

        for call_op in ("CALL", "STATICCALL"):

            def call_hook(state: GlobalState):
                annotation = path_annotation(state)
                self.index.record_call(annotation.path)
                annotation.has_call = True

            symbolic_vm.pre_hook(call_op)(call_hook)

        for end_op in ("STOP", "RETURN"):
            symbolic_vm.pre_hook(end_op)(on_transaction_end)

        @symbolic_vm.laser_hook("add_world_state")
        def world_state_filter_hook(state: GlobalState):
            if isinstance(state.current_transaction, ContractCreationTransaction):
                self.iteration = 0
                return
            annotation = path_annotation(state)
            # keep the write cache for the next transaction; reset the rest
            annotation.path = [0]
            annotation.storage_loaded = {}
            world_annotation(state).annotations_stack.append(annotation)
