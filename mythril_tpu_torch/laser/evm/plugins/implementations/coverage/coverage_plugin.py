"""Instruction coverage plugin (reference surface:
mythril/laser/ethereum/plugins/implementations/coverage/coverage_plugin.py):
per-bytecode executed-instruction bitmap, logged per transaction and at the
end of symbolic execution."""

import logging
from typing import Dict, List, Tuple

from mythril_tpu_torch.laser.evm.plugins.plugin import LaserPlugin
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState

log = logging.getLogger(__name__)


class InstructionCoveragePlugin(LaserPlugin):
    """Measures instruction coverage: executed / total instructions per
    bytecode."""

    def __init__(self):
        self.coverage: Dict[str, Tuple[int, List[bool]]] = {}
        self.initial_coverage = 0
        self.tx_id = 0
        self._addr_maps: Dict[str, Dict[int, int]] = {}

    def initialize(self, symbolic_vm):
        self.coverage = {}
        self.initial_coverage = 0
        self.tx_id = 0
        self._addr_maps = {}

        @symbolic_vm.laser_hook("stop_sym_exec")
        def stop_sym_exec_hook():
            for code, code_cov in self.coverage.items():
                if code_cov[0] == 0:
                    continue
                cov_percentage = sum(code_cov[1]) / float(code_cov[0]) * 100
                log.info("Achieved %.2f%% coverage for code: %s", cov_percentage, code)

        @symbolic_vm.laser_hook("execute_state")
        def execute_state_hook(global_state: GlobalState):
            code = global_state.environment.code.bytecode
            if code not in self.coverage.keys():
                number_of_instructions = len(
                    global_state.environment.code.instruction_list
                )
                self.coverage[code] = (
                    number_of_instructions,
                    [False] * number_of_instructions,
                )
            if global_state.mstate.pc < len(self.coverage[code][1]):
                self.coverage[code][1][global_state.mstate.pc] = True

        @symbolic_vm.laser_hook("device_coverage")
        def device_coverage_hook(code_hex: str, byte_offsets: List[int]):
            """Instructions retired on device (tpu-batch backend) land in
            the same per-bytecode bitmap the host execute_state hook
            fills — coverage % is strategy-independent."""
            from mythril_tpu_torch.disassembler.asm import disassemble

            addr_map = self._addr_maps.get(code_hex)
            if addr_map is None:
                instructions = disassemble(bytes.fromhex(code_hex))
                addr_map = {
                    instr["address"]: i for i, instr in enumerate(instructions)
                }
                self._addr_maps[code_hex] = addr_map
                if code_hex not in self.coverage:
                    self.coverage[code_hex] = (
                        len(instructions),
                        [False] * len(instructions),
                    )
            bitmap = self.coverage[code_hex][1]
            for offset in byte_offsets:
                idx = addr_map.get(offset)
                if idx is not None and idx < len(bitmap):
                    bitmap[idx] = True

        @symbolic_vm.laser_hook("start_sym_trans")
        def execute_start_sym_trans_hook():
            self.initial_coverage = self._get_covered_instructions()

        @symbolic_vm.laser_hook("stop_sym_trans")
        def execute_stop_sym_trans_hook():
            end_coverage = self._get_covered_instructions()
            log.info(
                "Number of new instructions covered in tx %d: %d",
                self.tx_id,
                end_coverage - self.initial_coverage,
            )
            self.tx_id += 1

    def _get_covered_instructions(self) -> int:
        return sum(sum(cv[1]) for cv in self.coverage.values())

    def is_instruction_covered(self, bytecode, index) -> bool:
        if bytecode not in self.coverage.keys():
            return False
        try:
            return self.coverage[bytecode][1][index]
        except IndexError:
            return False
