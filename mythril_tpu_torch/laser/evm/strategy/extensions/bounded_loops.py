"""Loop-bound strategy decorator.

Parity surface:
mythril/laser/ethereum/strategy/extensions/bounded_loops.py.

Each state carries a trace of visited instruction addresses (appended at
selection time). When a state is selected AT a jumpdest, the decorator
looks for the previous occurrence of the trace's final address pair; the
span between occurrences is the loop body, and the number of contiguous
repetitions of that span at the trace's tail is the loop count. States
beyond `-b` are dropped. Creation transactions get a more generous bound
(constructor loops initialize storage and rarely explode)."""

import logging
from copy import copy
from typing import Dict, List

from mythril_tpu_torch.laser.evm.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState
from mythril_tpu_torch.laser.evm.strategy import BasicSearchStrategy
from mythril_tpu_torch.laser.evm.transaction import ContractCreationTransaction

log = logging.getLogger(__name__)

CREATION_MIN_BOUND = 8


class JumpdestCountAnnotation(StateAnnotation):
    """Trace of addresses this state's path has visited."""

    def __init__(self) -> None:
        self._reached_count: Dict[int, int] = {}
        self.trace: List[int] = []

    def __copy__(self):
        clone = JumpdestCountAnnotation()
        clone._reached_count = copy(self._reached_count)
        clone.trace = copy(self.trace)
        return clone


def _trace_of(state: GlobalState) -> JumpdestCountAnnotation:
    for annotation in state.get_annotations(JumpdestCountAnnotation):
        return annotation
    annotation = JumpdestCountAnnotation()
    state.annotate(annotation)
    return annotation


class BoundedLoopsStrategy(BasicSearchStrategy):
    """Drops states whose trace tail repeats a cycle more than `bound`
    times."""

    def __init__(self, super_strategy: BasicSearchStrategy, *args) -> None:
        self.super_strategy = super_strategy
        self.bound = args[0][0]
        self.skipped = 0  # observability: states dropped by the bound
        log.info(
            "Loaded search strategy extension: Loop bounds (limit = %d)", self.bound
        )
        BasicSearchStrategy.__init__(
            self, super_strategy.work_list, super_strategy.max_depth
        )

    # -- cycle detection -------------------------------------------------------

    @staticmethod
    def calculate_hash(i: int, j: int, trace: List[int]) -> int:
        """Order-sensitive fingerprint of trace[i:j]."""
        key = 0
        for position in range(i, j):
            key |= trace[position] << ((position - i) * 8)
        return key

    @staticmethod
    def count_key(trace: List[int], key: int, start: int, size: int) -> int:
        """Contiguous repetitions of the size-`size` cycle ending at
        `start`, walking backwards."""
        count = 0
        position = start
        while position >= 0:
            if BoundedLoopsStrategy.calculate_hash(position, position + size, trace) != key:
                break
            count += 1
            position -= size
        return count

    def _loop_count(self, trace: List[int]) -> int:
        """Repetitions of the cycle at the trace's tail (0 = no cycle)."""
        if len(trace) < 4:
            return 0
        previous_pair = None
        for i in range(len(trace) - 3, 0, -1):
            if trace[i] == trace[-2] and trace[i + 1] == trace[-1]:
                previous_pair = i
                break
        if previous_pair is None:
            return 0
        key = self.calculate_hash(previous_pair, len(trace) - 1, trace)
        size = len(trace) - previous_pair - 1
        return self.count_key(trace, key, previous_pair, size)

    # -- selection ---------------------------------------------------------------

    def get_strategic_global_state(self) -> GlobalState:
        while True:
            state = self.super_strategy.get_strategic_global_state()
            annotation = _trace_of(state)

            current = state.get_current_instruction()
            annotation.trace.append(current["address"])

            if current["opcode"].upper() != "JUMPDEST":
                return state

            count = self._loop_count(annotation.trace)
            if isinstance(
                state.current_transaction, ContractCreationTransaction
            ) and count < max(CREATION_MIN_BOUND, self.bound):
                return state
            if count > self.bound:
                log.debug("Loop bound reached, skipping state")
                self.skipped += 1
                continue
            return state
