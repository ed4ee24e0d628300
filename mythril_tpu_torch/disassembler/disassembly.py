"""Disassembly object with function-dispatcher resolution (reference surface:
mythril/disassembler/disassembly.py — bytecode + instruction list + mapping
of dispatcher entry addresses to function names/selectors)."""

import logging
from typing import Dict, List

from mythril_tpu_torch.disassembler import asm
from mythril_tpu_torch.support.signatures import SignatureDB

log = logging.getLogger(__name__)


class Disassembly(object):
    """Disassembly class: bytecode, instruction list, and the
    selector/function-name maps recovered from the solidity dispatcher
    pattern (PUSH4 <selector> ... EQ ... PUSH <target> JUMPI)."""

    def __init__(self, code: str, enable_online_lookup: bool = False):
        self.bytecode = code
        self.instruction_list = asm.disassemble(code)
        self.func_hashes: List[str] = []
        self.function_name_to_address: Dict[str, int] = {}
        self.address_to_function_name: Dict[int, str] = {}
        self.enable_online_lookup = enable_online_lookup
        self._static_analysis = None
        self._jumpdest_index = None
        self.assign_bytecode(bytecode=code)

    @property
    def static_analysis(self):
        """Lazily-built static pre-analysis tables for this bytecode
        (analysis/static_pass/); None when the code is empty or the pass
        fails — callers must treat that as "no static facts"."""
        if self._static_analysis is None and self.bytecode:
            from mythril_tpu_torch.analysis import static_pass

            try:
                self._static_analysis = static_pass.analyze(self.bytecode)
            except Exception:  # degrade: analysis is advisory on the host
                log.warning(
                    "static pass failed for bytecode of length %d",
                    len(self.bytecode),
                    exc_info=True,
                )
        return self._static_analysis

    @property
    def jumpdest_index(self) -> Dict[int, int]:
        """byte address -> instruction_list index for every JUMPDEST."""
        if self._jumpdest_index is None:
            self._jumpdest_index = {
                instr["address"]: i
                for i, instr in enumerate(self.instruction_list)
                if instr["opcode"] == "JUMPDEST"
            }
        return self._jumpdest_index

    def assign_bytecode(self, bytecode):
        self.bytecode = bytecode
        self.instruction_list = asm.disassemble(bytecode)
        self._static_analysis = None
        self._jumpdest_index = None
        signatures = SignatureDB(enable_online_lookup=self.enable_online_lookup)
        jump_table_indices = asm.find_op_code_sequence(
            [("PUSH1", "PUSH2", "PUSH3", "PUSH4"), ("EQ",)], self.instruction_list
        )
        for index in jump_table_indices:
            function_hash, jump_target, function_name = get_function_info(
                index, self.instruction_list, signatures
            )
            if function_hash in self.func_hashes:
                continue
            self.func_hashes.append(function_hash)
            if jump_target is not None and function_name is not None:
                self.function_name_to_address[function_name] = jump_target
                self.address_to_function_name[jump_target] = function_name

    def get_easm(self) -> str:
        return asm.instruction_list_to_easm(self.instruction_list)


def get_function_info(index: int, instruction_list: list, signature_database: SignatureDB):
    """Resolve a dispatcher entry at `index` (a PUSHn directly followed by EQ)
    into (selector_hex, jump_target_address, function_name)."""
    function_hash = instruction_list[index]["argument"]
    if isinstance(function_hash, str):
        # normalize to 4-byte 0x-prefixed selector
        raw = function_hash[2:] if function_hash.startswith("0x") else function_hash
        function_hash = "0x" + raw.rjust(8, "0")

    function_names = signature_database.get(function_hash)
    if len(function_names) > 0:
        function_name = function_names[0]
    else:
        function_name = "_function_" + function_hash

    # find the PUSH of the jump target within the next few instructions
    entry_point = None
    for i in range(index + 2, min(index + 5, len(instruction_list))):
        op = instruction_list[i]["opcode"]
        if op.startswith("PUSH"):
            try:
                entry_point = int(instruction_list[i]["argument"], 16)
            except (ValueError, TypeError):
                pass
            break
        if op == "JUMPI":
            break
    return function_hash, entry_point, function_name
