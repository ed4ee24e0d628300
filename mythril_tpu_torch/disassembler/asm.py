"""EVM (dis)assembly helpers.

Covers the reference surface (mythril/disassembler/asm.py: disassemble,
EvmInstruction, instruction_list_to_easm, find_op_code_sequence,
get_opcode_from_name) and additionally ships an *assembler* with label
support — this repo has no solc dependency, so test contracts and benchmark
corpora are authored directly in EVM assembly (see tests/ and
mythril_tpu/corpus/).
"""

import re
from typing import Generator, List, Optional

from mythril_tpu_torch.support.opcodes import OPCODES, reverse_opcodes

regex_PUSH = re.compile(r"^PUSH(\d*)$")

# solidity metadata markers (swarm / ipfs hashes appended to runtime code)
_METADATA_MARKERS = (
    bytes.fromhex("a165627a7a72305820"),  # bzzr0
    bytes.fromhex("a265627a7a72315820"),  # bzzr1
    bytes.fromhex("a264697066735822"),  # ipfs
)


class EvmInstruction:
    """A disassembled instruction: address, mnemonic, optional argument.

    ``truncated`` marks a PUSH whose immediate ran past the end of the
    bytecode; its argument is zero-padded on the right (EVM semantics:
    reads past the code end yield zero bytes)."""

    def __init__(
        self,
        address: int,
        op_code: str,
        argument: Optional[str] = None,
        truncated: bool = False,
    ):
        self.address = address
        self.op_code = op_code
        self.argument = argument
        self.truncated = truncated

    def to_dict(self) -> dict:
        result = {"address": self.address, "opcode": self.op_code}
        if self.argument:
            result["argument"] = self.argument
        if self.truncated:
            result["truncated"] = True
        return result


def _metadata_offset(bytecode: bytes) -> int:
    """Index where trailing solidity metadata starts, or len(bytecode)."""
    for marker in _METADATA_MARKERS:
        idx = bytecode.rfind(marker)
        if idx >= 0:
            return idx
    return len(bytecode)


def disassemble(bytecode: bytes) -> List[dict]:
    """Disassemble bytecode into a list of instruction dicts."""
    if isinstance(bytecode, str):
        bytecode = bytes.fromhex(bytecode[2:] if bytecode.startswith("0x") else bytecode)
    instruction_list = []
    address = 0
    length = _metadata_offset(bytecode)
    while address < length:
        spec = OPCODES.get(bytecode[address])
        if spec is None:
            instruction_list.append(EvmInstruction(address, "INVALID"))
            address += 1
            continue
        match_push = regex_PUSH.match(spec.name)
        if match_push:
            width = int(match_push.group(1))
            data = bytecode[address + 1 : address + 1 + width]
            # an immediate cut off by the end of the bytecode pads with
            # zeros on the RIGHT (the EVM reads implicit zero bytes past
            # the code end); "0x" + data.hex() alone would silently parse
            # to the wrong (left-aligned) value
            argument = "0x" + data.hex() + "00" * (width - len(data))
            instruction_list.append(
                EvmInstruction(
                    address, spec.name, argument, truncated=len(data) < width
                )
            )
            address += 1 + width
        else:
            instruction_list.append(EvmInstruction(address, spec.name))
            address += 1
    return [instruction.to_dict() for instruction in instruction_list]


def instruction_list_to_easm(instruction_list: List[dict]) -> str:
    """Render an instruction list as an easm string."""
    result = ""
    for instruction in instruction_list:
        result += "{} {}".format(instruction["address"], instruction["opcode"])
        if "argument" in instruction:
            result += " " + instruction["argument"]
        result += "\n"
    return result


def get_opcode_from_name(operation_name: str) -> int:
    """Get an opcode byte from its mnemonic."""
    try:
        return reverse_opcodes[operation_name]
    except KeyError:
        raise RuntimeError("Unknown opcode: %s" % operation_name)


def is_sequence_match(pattern: List[List[str]], instruction_list: List[dict], index: int) -> bool:
    """Check if the instructions starting at index match a pattern (a list of
    alternative-mnemonic lists)."""
    for index, pattern_slot in enumerate(pattern, start=index):
        try:
            if instruction_list[index]["opcode"] not in pattern_slot:
                return False
        except IndexError:
            return False
    return True


def find_op_code_sequence(pattern: List[List[str]], instruction_list: List[dict]) -> Generator:
    """Yield all indices where the pattern matches."""
    for i in range(0, len(instruction_list) - len(pattern) + 1):
        if is_sequence_match(pattern, instruction_list, i):
            yield i


# ---------------------------------------------------------------------------
# Assembler (in-repo addition; no reference equivalent)


class AssembleError(Exception):
    pass


def assemble(source: str) -> bytes:
    """Assemble EVM assembly text into bytecode.

    Syntax: one instruction per line; `;` comments; `NAME:` defines a label;
    `PUSH2 :NAME` (or any PUSHn) pushes a label address; `PUSHn 0x..`/decimal
    pushes a constant. Two passes (label resolution).
    """
    lines = []
    for raw_line in source.splitlines():
        line = raw_line.split(";")[0].strip()
        if line:
            lines.append(line)

    # pass 1: compute addresses
    labels = {}
    address = 0
    parsed = []  # (mnemonic, arg_str or None)
    for line in lines:
        if line.endswith(":"):
            labels[line[:-1]] = address
            continue
        parts = line.split()
        mnemonic = parts[0].upper()
        # accept modern aliases for the table's legacy names
        mnemonic = {"SELFDESTRUCT": "SUICIDE", "KECCAK256": "SHA3", "INVALID": "ASSERT_FAIL"}.get(
            mnemonic, mnemonic
        )
        arg = parts[1] if len(parts) > 1 else None
        match_push = regex_PUSH.match(mnemonic)
        if mnemonic not in reverse_opcodes:
            raise AssembleError("unknown mnemonic %r" % mnemonic)
        parsed.append((mnemonic, arg))
        address += 1 + (int(match_push.group(1)) if match_push else 0)

    # pass 2: emit
    out = bytearray()
    for mnemonic, arg in parsed:
        out.append(reverse_opcodes[mnemonic])
        match_push = regex_PUSH.match(mnemonic)
        if match_push:
            width = int(match_push.group(1))
            if width == 0:  # PUSH0 takes no immediate
                continue
            if arg is None:
                raise AssembleError("%s needs an argument" % mnemonic)
            if arg.startswith(":"):
                label = arg[1:]
                if label not in labels:
                    raise AssembleError("undefined label %r" % label)
                value = labels[label]
            elif arg.startswith("0x"):
                value = int(arg, 16)
            else:
                value = int(arg)
            out += value.to_bytes(width, "big")
        elif arg is not None:
            raise AssembleError("%s takes no argument" % mnemonic)
    return bytes(out)
