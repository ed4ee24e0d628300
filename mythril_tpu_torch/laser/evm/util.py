"""Utility conversions between ints/bytes/BitVecs (reference surface:
mythril/laser/ethereum/util.py). `get_concrete_int` embodies the pervasive
"concretize or bail" idiom: symbolic values raise TypeError, which callers
catch to fall back to symbolic handling."""

import re
from typing import List, Union

from mythril_tpu_torch.smt import BitVec, Bool, Expression, If, simplify, symbol_factory

TT256 = 2**256
TT256M1 = 2**256 - 1
TT255 = 2**255


def safe_decode(hex_encoded_string: str) -> bytes:
    if hex_encoded_string.startswith("0x"):
        return bytes.fromhex(hex_encoded_string[2:])
    return bytes.fromhex(hex_encoded_string)


def to_signed(i: int) -> int:
    return i if i < TT255 else i - TT256


def get_instruction_index(instruction_list: List[dict], address: int) -> Union[int, None]:
    """Index of the instruction at a bytecode address."""
    index = 0
    for instr in instruction_list:
        if instr["address"] >= address:
            return index
        index += 1
    return None


def get_trace_line(instr: dict, state) -> str:
    stack = str(state.stack[::-1])
    stack = re.sub("\n", "", stack)
    return str(instr["address"]) + " " + instr["opcode"] + "\tSTACK: " + stack


def pop_bitvec(state) -> BitVec:
    """Pop one stack item, coercing bools/ints to 256-bit BitVecs."""
    item = state.stack.pop()
    if isinstance(item, Bool):
        return If(
            item, symbol_factory.BitVecVal(1, 256), symbol_factory.BitVecVal(0, 256)
        )
    if isinstance(item, int):
        return symbol_factory.BitVecVal(item, 256)
    return simplify(item)


def get_concrete_int(item: Union[int, Expression]) -> int:
    """The concrete value of item; raises TypeError when symbolic."""
    if isinstance(item, int):
        return item
    if isinstance(item, BitVec):
        if item.value is None:
            raise TypeError("Symbolic computation results are not supported.")
        return item.value
    if isinstance(item, Bool):
        value = item.value
        if value is None:
            raise TypeError("Symbolic computation results are not supported.")
        return int(value)
    raise TypeError("Unsupported type: %r" % type(item))


def concrete_int_from_bytes(concrete_bytes: Union[List[Union[BitVec, int]], bytes], start_index: int) -> int:
    """Big-endian int from a 32-byte slice (symbolic members raise)."""
    concrete_bytes = [
        byte.value if isinstance(byte, BitVec) and not byte.symbolic else byte
        for byte in concrete_bytes
    ]
    integer_bytes = concrete_bytes[start_index : start_index + 32]
    if any(isinstance(byte, Expression) for byte in integer_bytes):
        raise TypeError("Unsupported symbolic bytearray element")
    return int.from_bytes(bytes(integer_bytes), "big")


def concrete_int_to_bytes(val: Union[int, Expression]) -> bytes:
    """32-byte big-endian encoding of a concrete value."""
    if isinstance(val, int):
        return val.to_bytes(32, byteorder="big")
    return get_concrete_int(val).to_bytes(32, byteorder="big")


def extract_copy(data: bytearray, mem: bytearray, memstart: int, datastart: int, size: int):
    for i in range(size):
        if datastart + i < len(data):
            mem[memstart + i] = data[datastart + i]
        else:
            mem[memstart + i] = 0


def extract32(data: bytearray, i: int) -> int:
    if i >= len(data):
        return 0
    o = data[i : min(i + 32, len(data))]
    o += bytearray(32 - len(o))
    return int.from_bytes(o, "big")
