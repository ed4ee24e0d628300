"""Precompiled contracts 0x1-0x9 (reference surface:
mythril/laser/ethereum/natives.py). Handlers are concrete-only: symbolic
inputs raise NativeContractException and the caller writes symbolic
return data instead (call.py)."""

import hashlib
import logging
from typing import List

from mythril_tpu_torch.laser.evm.state.calldata import BaseCalldata, ConcreteCalldata
from mythril_tpu_torch.laser.evm.util import extract32, extract_copy
from mythril_tpu_torch.support import crypto

log = logging.getLogger(__name__)


class NativeContractException(Exception):
    """Exception denoting an error during a native contract call (usually:
    symbolic input)."""


def int_to_32bytes(i: int) -> bytes:
    o = [0] * 32
    for x in range(32):
        o[31 - x] = i & 0xFF
        i >>= 8
    return bytes(o)


def _concrete_data(data: BaseCalldata) -> bytearray:
    try:
        return bytearray(data.concrete(None))
    except TypeError:
        raise NativeContractException


def ecrecover(data: List[int]) -> List[int]:
    try:
        byte_data = bytes(data)
        v = extract32(bytearray(byte_data), 32)
        r = extract32(bytearray(byte_data), 64)
        s = extract32(bytearray(byte_data), 96)
    except TypeError:
        raise NativeContractException
    message = byte_data[0:32].ljust(32, b"\x00")
    if v < 27 or v > 28 or r >= crypto._N or s >= crypto._N or r == 0 or s == 0:
        return []
    try:
        address = crypto.ecrecover_to_address(message, v, r, s)
    except ValueError:
        return []
    return list(int_to_32bytes(address))


def sha256(data: List[int]) -> List[int]:
    try:
        byte_data = bytes(data)
    except TypeError:
        raise NativeContractException
    return list(hashlib.sha256(byte_data).digest())


def ripemd160(data: List[int]) -> List[int]:
    try:
        byte_data = bytes(data)
    except TypeError:
        raise NativeContractException
    digest = b"\x00" * 12 + crypto.ripemd160(byte_data)
    return list(digest)


def identity(data: List[int]) -> List[int]:
    # newer versions of the calldata model return BitVec members; they pass
    # through unchanged (identity need not concretize)
    return data


def mod_exp(data: List[int]) -> List[int]:
    """EIP-198 modular exponentiation."""
    bytearray_data = bytearray(data)
    try:
        baselen = extract32(bytearray_data, 0)
        explen = extract32(bytearray_data, 32)
        modlen = extract32(bytearray_data, 64)
    except TypeError:
        raise NativeContractException
    if baselen == 0:
        return [0] * modlen
    if modlen == 0:
        return []
    base = bytearray(baselen)
    extract_copy(bytearray_data, base, 0, 96, baselen)
    exp = bytearray(explen)
    extract_copy(bytearray_data, exp, 0, 96 + baselen, explen)
    mod = bytearray(modlen)
    extract_copy(bytearray_data, mod, 0, 96 + baselen + explen, modlen)
    if int.from_bytes(mod, "big") == 0:
        return [0] * modlen
    o = pow(int.from_bytes(base, "big"), int.from_bytes(exp, "big"), int.from_bytes(mod, "big"))
    return list(o.to_bytes(modlen, "big"))


def ec_add(data: List[int]) -> List[int]:
    bytearray_data = bytearray(data)
    try:
        x1 = extract32(bytearray_data, 0)
        y1 = extract32(bytearray_data, 32)
        x2 = extract32(bytearray_data, 64)
        y2 = extract32(bytearray_data, 96)
    except TypeError:
        raise NativeContractException
    try:
        p1 = crypto.validate_bn128_point(x1, y1)
        p2 = crypto.validate_bn128_point(x2, y2)
        result = crypto.bn128_add(p1, p2)
    except ValueError:
        return []
    x, y = result if result is not None else (0, 0)
    return list(int_to_32bytes(x)) + list(int_to_32bytes(y))


def ec_mul(data: List[int]) -> List[int]:
    bytearray_data = bytearray(data)
    try:
        x = extract32(bytearray_data, 0)
        y = extract32(bytearray_data, 32)
        m = extract32(bytearray_data, 64)
    except TypeError:
        raise NativeContractException
    try:
        pt = crypto.validate_bn128_point(x, y)
        result = crypto.bn128_mul(pt, m)
    except ValueError:
        return []
    x_out, y_out = result if result is not None else (0, 0)
    return list(int_to_32bytes(x_out)) + list(int_to_32bytes(y_out))


def ec_pair(data: List[int]) -> List[int]:
    """EIP-197 pairing check (precompile 0x8)."""
    if len(data) % 192:
        return []
    try:
        bytearray_data = bytearray(bytes(data))
    except TypeError:
        raise NativeContractException
    try:
        from mythril_tpu_torch.support import bn128_pairing
    except ImportError:
        # pairing backend not present: fall back to symbolic return data
        raise NativeContractException
    try:
        ok = bn128_pairing.pairing_check(bytes(bytearray_data))
    except ValueError:
        return []
    return list(int_to_32bytes(1 if ok else 0))


def blake2b_fcompress(data: List[int]) -> List[int]:
    """EIP-152 blake2b F compression (precompile 0x9)."""
    try:
        byte_data = bytes(data)
    except TypeError:
        raise NativeContractException
    if len(byte_data) != 213 or byte_data[212] not in (0, 1):
        return []
    rounds = int.from_bytes(byte_data[0:4], "big")
    h = [int.from_bytes(byte_data[4 + 8 * i : 12 + 8 * i], "little") for i in range(8)]
    m = [int.from_bytes(byte_data[68 + 8 * i : 76 + 8 * i], "little") for i in range(16)]
    t = (
        int.from_bytes(byte_data[196:204], "little"),
        int.from_bytes(byte_data[204:212], "little"),
    )
    final = byte_data[212] == 1
    out = crypto.blake2b_compress(rounds, h, m, t, final)
    result = b"".join(x.to_bytes(8, "little") for x in out)
    return list(result)


PRECOMPILE_FUNCTIONS = (
    ecrecover,
    sha256,
    ripemd160,
    identity,
    mod_exp,
    ec_add,
    ec_mul,
    ec_pair,
    blake2b_fcompress,
)
PRECOMPILE_COUNT = len(PRECOMPILE_FUNCTIONS)


def native_contracts(address: int, data: BaseCalldata) -> List[int]:
    """Dispatch a precompile call (1-indexed address)."""
    if not isinstance(data, ConcreteCalldata):
        raise NativeContractException
    concrete_data = data.concrete(None)
    try:
        functions_data = [
            d if isinstance(d, int) else d.value for d in concrete_data
        ]
        if any(d is None for d in functions_data):
            raise NativeContractException
    except AttributeError:
        raise NativeContractException
    return PRECOMPILE_FUNCTIONS[address - 1](functions_data)
