"""Frozen copy of ``mythril_tpu_torch/support/opcodes.py`` (imports pointed at this package).

The EVM opcode table.

Unifies the two tables the reference keeps (mythril/support/opcodes.py:4 —
{byte: (name, pops, pushes, gas)} — and the per-opcode (min_gas, max_gas) /
stack metadata in mythril/laser/ethereum/instruction_data.py:16) into one
spec table, exposing the same lookups both layers need. Gas bounds follow
the reference's Istanbul-ish budget model (min/max per opcode; dynamic
parts — memory expansion, sha3 words, calls — are added by the interpreter).
"""

from typing import Dict, NamedTuple, Tuple


class OpSpec(NamedTuple):
    name: str
    pops: int
    pushes: int
    min_gas: int
    max_gas: int


def _spec(name, pops, pushes, gas, max_gas=None) -> OpSpec:
    return OpSpec(name, pops, pushes, gas, gas if max_gas is None else max_gas)


OPCODES: Dict[int, OpSpec] = {
    0x00: _spec("STOP", 0, 0, 0),
    0x01: _spec("ADD", 2, 1, 3),
    0x02: _spec("MUL", 2, 1, 5),
    0x03: _spec("SUB", 2, 1, 3),
    0x04: _spec("DIV", 2, 1, 5),
    0x05: _spec("SDIV", 2, 1, 5),
    0x06: _spec("MOD", 2, 1, 5),
    0x07: _spec("SMOD", 2, 1, 5),
    0x08: _spec("ADDMOD", 3, 1, 8),
    0x09: _spec("MULMOD", 3, 1, 8),
    0x0A: _spec("EXP", 2, 1, 10, 340),  # exponent bytes add 30/50 per byte
    0x0B: _spec("SIGNEXTEND", 2, 1, 5),
    0x10: _spec("LT", 2, 1, 3),
    0x11: _spec("GT", 2, 1, 3),
    0x12: _spec("SLT", 2, 1, 3),
    0x13: _spec("SGT", 2, 1, 3),
    0x14: _spec("EQ", 2, 1, 3),
    0x15: _spec("ISZERO", 1, 1, 3),
    0x16: _spec("AND", 2, 1, 3),
    0x17: _spec("OR", 2, 1, 3),
    0x18: _spec("XOR", 2, 1, 3),
    0x19: _spec("NOT", 1, 1, 3),
    0x1A: _spec("BYTE", 2, 1, 3),
    0x1B: _spec("SHL", 2, 1, 3),
    0x1C: _spec("SHR", 2, 1, 3),
    0x1D: _spec("SAR", 2, 1, 3),
    0x20: _spec("SHA3", 2, 1, 30, 30 + 6 * 8),
    0x30: _spec("ADDRESS", 0, 1, 2),
    0x31: _spec("BALANCE", 1, 1, 700),
    0x32: _spec("ORIGIN", 0, 1, 2),
    0x33: _spec("CALLER", 0, 1, 2),
    0x34: _spec("CALLVALUE", 0, 1, 2),
    0x35: _spec("CALLDATALOAD", 1, 1, 3),
    0x36: _spec("CALLDATASIZE", 0, 1, 2),
    0x37: _spec("CALLDATACOPY", 3, 0, 2, 2 + 3 * 768),
    0x38: _spec("CODESIZE", 0, 1, 2),
    0x39: _spec("CODECOPY", 3, 0, 2, 2 + 3 * 768),
    0x3A: _spec("GASPRICE", 0, 1, 2),
    0x3B: _spec("EXTCODESIZE", 1, 1, 700),
    0x3C: _spec("EXTCODECOPY", 4, 0, 700, 700 + 3 * 768),
    0x3D: _spec("RETURNDATASIZE", 0, 1, 2),
    0x3E: _spec("RETURNDATACOPY", 3, 0, 3),
    0x3F: _spec("EXTCODEHASH", 1, 1, 700),
    0x40: _spec("BLOCKHASH", 1, 1, 20),
    0x41: _spec("COINBASE", 0, 1, 2),
    0x42: _spec("TIMESTAMP", 0, 1, 2),
    0x43: _spec("NUMBER", 0, 1, 2),
    0x44: _spec("DIFFICULTY", 0, 1, 2),
    0x45: _spec("GASLIMIT", 0, 1, 2),
    0x46: _spec("CHAINID", 0, 1, 2),
    0x47: _spec("SELFBALANCE", 0, 1, 5),
    0x48: _spec("BASEFEE", 0, 1, 2),
    0x50: _spec("POP", 1, 0, 2),
    0x51: _spec("MLOAD", 1, 1, 3, 96),
    0x52: _spec("MSTORE", 2, 0, 3, 98),
    0x53: _spec("MSTORE8", 2, 0, 3, 98),
    0x54: _spec("SLOAD", 1, 1, 800),
    0x55: _spec("SSTORE", 2, 0, 5000, 25000),
    0x56: _spec("JUMP", 1, 0, 8),
    0x57: _spec("JUMPI", 2, 0, 10),
    0x58: _spec("PC", 0, 1, 2),
    0x59: _spec("MSIZE", 0, 1, 2),
    0x5A: _spec("GAS", 0, 1, 2),
    0x5B: _spec("JUMPDEST", 0, 0, 1),
    0xA0: _spec("LOG0", 2, 0, 375, 375 + 8 * 32),
    0xA1: _spec("LOG1", 3, 0, 2 * 375, 2 * 375 + 8 * 32),
    0xA2: _spec("LOG2", 4, 0, 3 * 375, 3 * 375 + 8 * 32),
    0xA3: _spec("LOG3", 5, 0, 4 * 375, 4 * 375 + 8 * 32),
    0xA4: _spec("LOG4", 6, 0, 5 * 375, 5 * 375 + 8 * 32),
    0xF0: _spec("CREATE", 3, 1, 32000),
    0xF1: _spec("CALL", 7, 1, 700, 700 + 9000 + 25000),
    0xF2: _spec("CALLCODE", 7, 1, 700, 700 + 9000 + 25000),
    0xF3: _spec("RETURN", 2, 0, 0),
    0xF4: _spec("DELEGATECALL", 6, 1, 700, 700 + 9000 + 25000),
    0xF5: _spec("CREATE2", 4, 1, 32000),
    0xFA: _spec("STATICCALL", 6, 1, 700, 700 + 9000 + 25000),
    0xFD: _spec("REVERT", 2, 0, 0),
    0xFE: _spec("ASSERT_FAIL", 0, 0, 0),  # designated invalid (0xfe)
    0xFF: _spec("SUICIDE", 1, 0, 5000, 30000),
}

OPCODES[0x5F] = _spec("PUSH0", 0, 1, 2)  # EIP-3855 (Shanghai)
for _i in range(1, 33):
    OPCODES[0x5F + _i] = _spec("PUSH" + str(_i), 0, 1, 3)
for _i in range(1, 17):
    OPCODES[0x7F + _i] = _spec("DUP" + str(_i), _i, _i + 1, 3)
    OPCODES[0x8F + _i] = _spec("SWAP" + str(_i), _i + 1, _i + 1, 3)

# name -> byte
reverse_opcodes: Dict[str, int] = {spec.name: byte for byte, spec in OPCODES.items()}

# name -> spec, including names without a (single) byte of their own: the
# disassembler emits "INVALID" for undefined bytes
NAME_SPECS: Dict[str, OpSpec] = {spec.name: spec for spec in OPCODES.values()}
NAME_SPECS["INVALID"] = _spec("INVALID", 0, 0, 0)

# compatibility view mirroring the reference's {byte: (name, pops, pushes, gas)}
opcodes: Dict[int, Tuple[str, int, int, int]] = {
    byte: (spec.name, spec.pops, spec.pushes, spec.min_gas)
    for byte, spec in OPCODES.items()
}

# gas formula constants (the reference pulls these from pyethereum's
# ethereum.opcodes; values per Istanbul)
GSHA3WORD = 6
GSTORAGEADD = 20000
GSTORAGEMOD = 5000
GSTORAGEREFUND = 15000
GCALLVALUETRANSFER = 9000
GCALLNEWACCOUNT = 25000
GSTIPEND = 2300
GMEMORY = 3
GQUADRATICMEMDENOM = 512
GCOPY = 3
GEXPONENTBYTE = 50
GECRECOVER = 3000
GSHA256BASE = 60
GSHA256WORD = 12
GRIPEMD160BASE = 600
GRIPEMD160WORD = 120
GIDENTITYBASE = 15
GIDENTITYWORD = 3
CREATE_CONTRACT_ADDRESS_GAS = 25000


def ceil32(x: int) -> int:
    return ((x + 31) // 32) * 32


def get_opcode_gas(opcode: str) -> Tuple[int, int]:
    spec = NAME_SPECS[opcode]
    return spec.min_gas, spec.max_gas


def get_required_stack_elements(opcode: str) -> int:
    return NAME_SPECS[opcode].pops


def calculate_sha3_gas(length: int) -> Tuple[int, int]:
    gas_val = 30 + GSHA3WORD * (ceil32(length) // 32)
    return gas_val, gas_val


def calculate_native_gas(size: int, contract: str) -> Tuple[int, int]:
    word_num = ceil32(size) // 32
    if contract == "ecrecover":
        gas_value = GECRECOVER
    elif contract == "sha256":
        gas_value = GSHA256BASE + word_num * GSHA256WORD
    elif contract == "ripemd160":
        gas_value = GRIPEMD160BASE + word_num * GRIPEMD160WORD
    elif contract == "identity":
        gas_value = GIDENTITYBASE + word_num * GIDENTITYWORD
    else:
        gas_value = 0
    return gas_value, gas_value
