"""Work-list selection policies.

Parity surface: mythril/laser/ethereum/strategy/basic.py — DFS/BFS pop
opposite ends of the shared work list; the two random strategies draw
uniformly / weighted by 1/(depth+1). StaticDistanceWeightedStrategy is
an addition: it weights by the static pass's interesting-op distance."""

import random
from typing import List

from mythril_tpu_torch.laser.evm.state.global_state import GlobalState
from mythril_tpu_torch.laser.evm.strategy import BasicSearchStrategy


class DepthFirstSearchStrategy(BasicSearchStrategy):
    """LIFO: dive down one path before exploring siblings."""

    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop()


class BreadthFirstSearchStrategy(BasicSearchStrategy):
    """FIFO: advance the whole frontier in lockstep."""

    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop(0)


class ReturnRandomNaivelyStrategy(BasicSearchStrategy):
    """Uniform random draw from the work list."""

    def get_strategic_global_state(self) -> GlobalState:
        if not self.work_list:
            raise IndexError
        return self.work_list.pop(random.randrange(len(self.work_list)))

    def get_strategic_batch(self, batch_size: int) -> List[GlobalState]:
        batch: List[GlobalState] = []
        while len(batch) < batch_size and self.work_list:
            try:
                batch.append(next(self))
            except StopIteration:
                break
        return batch


class ReturnWeightedRandomStrategy(BasicSearchStrategy):
    """Random draw favoring shallow states (weight 1/(depth+1))."""

    def get_strategic_global_state(self) -> GlobalState:
        weights = [1 / (state.mstate.depth + 1) for state in self.work_list]
        chosen = random.choices(range(len(self.work_list)), weights)[0]
        return self.work_list.pop(chosen)


class StaticDistanceWeightedStrategy(BasicSearchStrategy):
    """Random draw favoring states close to an interesting op.

    Weight is 1/(1+d) where d is the static pass's interest_dist for the
    basic block containing the state's pc — the block distance to the
    nearest SSTORE/CALL-family/SELFDESTRUCT site, the places detection
    modules anchor on. States whose block cannot reach any interesting op
    (or with no static analysis available) fall back to the depth weight
    so the strategy degrades to ReturnWeightedRandomStrategy behaviour.
    """

    @staticmethod
    def _weight(state: GlobalState) -> float:
        fallback = 1 / (state.mstate.depth + 1)
        disassembly = state.environment.code
        analysis = getattr(disassembly, "static_analysis", None)
        if analysis is None:
            return fallback
        instr_list = disassembly.instruction_list
        pc = state.mstate.pc
        if pc >= len(instr_list):
            return fallback
        block = analysis.block_at(instr_list[pc]["address"])
        if block is None:
            return fallback
        dist = int(analysis.interest_dist[block])
        from mythril_tpu_torch.analysis.static_pass import INTEREST_INF

        if dist >= INTEREST_INF:
            return fallback
        return 1 / (1 + dist)

    def get_strategic_global_state(self) -> GlobalState:
        weights = [self._weight(state) for state in self.work_list]
        chosen = random.choices(range(len(self.work_list)), weights)[0]
        return self.work_list.pop(chosen)
