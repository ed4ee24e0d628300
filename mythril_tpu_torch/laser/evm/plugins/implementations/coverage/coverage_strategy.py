"""Coverage-guided selection.

Parity surface:
mythril/laser/ethereum/plugins/implementations/coverage/coverage_strategy.py
— scan the work list for a state whose next instruction has not been
covered yet; when everything pending is covered, defer to the wrapped
strategy's policy."""

from typing import Optional

from mythril_tpu_torch.laser.evm.plugins.implementations.coverage.coverage_plugin import (
    InstructionCoveragePlugin,
)
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState
from mythril_tpu_torch.laser.evm.strategy import BasicSearchStrategy


class CoverageStrategy(BasicSearchStrategy):
    """Decorator strategy: uncovered program points jump the queue."""

    def __init__(
        self,
        super_strategy: BasicSearchStrategy,
        instruction_coverage_plugin: InstructionCoveragePlugin,
    ):
        super().__init__(super_strategy.work_list, super_strategy.max_depth)
        self.super_strategy = super_strategy
        self.instruction_coverage_plugin = instruction_coverage_plugin

    def _first_uncovered_index(self) -> Optional[int]:
        """Work-list index of the first state sitting on an instruction
        the coverage bitmap has not seen, or None."""
        plugin = self.instruction_coverage_plugin
        for index, state in enumerate(self.work_list):
            code = state.environment.code.bytecode
            if not plugin.is_instruction_covered(code, state.mstate.pc):
                return index
        return None

    def get_strategic_global_state(self) -> GlobalState:
        index = self._first_uncovered_index()
        if index is not None:
            return self.work_list.pop(index)
        return self.super_strategy.get_strategic_global_state()
