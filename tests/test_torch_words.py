"""Port vs reference: 256-bit word arithmetic (mythril_tpu_torch/laser/cuda/words.py
against mythril_tpu/laser/tpu/words.py), bit for bit on the CPU.

Inputs are python ints from a numpy seed plus the edge values of the EVM
rules: 0, 1, 2^255, 2^256-1, x/0, SDIV -2^255/-1, shifts >= 256,
BYTE i >= 32 and SIGNEXTEND b >= 31."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser.tpu import words as rw
from mythril_tpu_torch.laser.cuda import words as pw

M256 = (1 << 256) - 1
EDGE = [0, 1, 2, 3, 31, 32, 255, 256, 257, 1 << 128, (1 << 255) - 1, 1 << 255, M256 - 1, M256,
        M256 - (1 << 255) + 5, 0xFF << 240]


def _vals(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        nbits = int(rng.integers(1, 257))
        out.append(int.from_bytes(rng.bytes(32), "big") >> (256 - nbits))
    return out


def _pairs():
    a = [x for x in EDGE for _ in EDGE] + _vals(1, 48)
    b = [y for _ in EDGE for y in EDGE] + _vals(2, 48)
    return a, b


def _ref(xs):
    return jnp.asarray(np.stack([rw.from_int(x) for x in xs]))


def _port(xs):
    return torch.as_tensor(np.stack([pw.from_int(x) for x in xs]).astype(np.int64))


def _same(ref_out, port_out):
    r = np.asarray(ref_out).astype(np.int64)
    p = port_out.numpy().astype(np.int64)
    if r.dtype == bool or p.dtype == bool:
        return np.array_equal(r.astype(bool), p.astype(bool))
    return np.array_equal(r & 0xFFFFFFFF, p & 0xFFFFFFFF)


BINARY = [
    ("add", rw.add, pw.add),
    ("sub", rw.sub, pw.sub),
    ("mul", rw.mul, pw.mul),
    ("mul_full", rw.mul_full, pw.mul_full),
    ("divmod_q", lambda a, b: rw.divmod256(a, b)[0], lambda a, b: pw.divmod256(a, b)[0]),
    ("divmod_r", lambda a, b: rw.divmod256(a, b)[1], lambda a, b: pw.divmod256(a, b)[1]),
    ("sdiv", rw.sdiv, pw.sdiv),
    ("smod", rw.smod, pw.smod),
    ("shl", rw.shl, pw.shl),
    ("shr", rw.shr, pw.shr),
    ("sar", rw.sar, pw.sar),
    ("byte", rw.byte_word, pw.byte_word),
    ("signextend", rw.signextend, pw.signextend),
    ("ult", rw.ult, pw.ult),
    ("ugt", rw.ugt, pw.ugt),
    ("slt", rw.slt, pw.slt),
    ("sgt", rw.sgt, pw.sgt),
    ("eq", rw.eq, pw.eq),
    ("and", lambda a, b: a & b, lambda a, b: a & b),
    ("or", lambda a, b: a | b, lambda a, b: a | b),
    ("xor", lambda a, b: a ^ b, lambda a, b: a ^ b),
]


@pytest.mark.parametrize("name,ref_fn,port_fn", BINARY, ids=[b[0] for b in BINARY])
def test_binary_ops_match_reference(name, ref_fn, port_fn):
    a, b = _pairs()
    if name in ("shl", "shr", "sar", "byte", "signextend"):
        # small first operands too: shift counts / byte indices around 0..300
        a = a + list(range(0, 300, 7)) + [256, 257, 1 << 32, 31, 32, 33]
        b = b + _vals(3, len(a) - len(b))
    assert _same(ref_fn(_ref(a), _ref(b)), port_fn(_port(a), _port(b))), name


@pytest.mark.parametrize("name", ["is_zero", "bit_not", "neg_abs"])
def test_unary_ops_match_reference(name):
    a = EDGE + _vals(4, 64)
    if name == "is_zero":
        assert _same(rw.is_zero(_ref(a)), pw.is_zero(_port(a)))
    elif name == "bit_not":
        assert _same(rw.bit_not(_ref(a)), pw.bit_not(_port(a)))
    else:
        assert _same(rw._abs_signed(_ref(a))[0], pw.abs_signed(_port(a))[0])


@pytest.mark.parametrize("op", ["addmod", "mulmod"])
def test_modular_ops_match_reference(op):
    a, b = _pairs()
    n = (EDGE * (len(a) // len(EDGE) + 1))[: len(a)]
    n = n[3:] + n[:3]
    ref_fn, port_fn = (rw.addmod, pw.addmod) if op == "addmod" else (rw.mulmod, pw.mulmod)
    assert _same(ref_fn(_ref(a), _ref(b), _ref(n)), port_fn(_port(a), _port(b), _port(n)))


def test_exp_matches_reference():
    a = EDGE[:8] + _vals(5, 8)
    e = [0, 1, 2, 255, 256, M256, 1 << 255, 3] + _vals(6, 8)
    assert _same(rw.exp(_ref(a), _ref(e)), pw.exp(_port(a), _port(e)))


def test_evm_edge_semantics():
    # the rules the reference encodes, checked on the port directly
    def w(x):
        return _port([x])

    assert pw.to_int(pw.divmod256(w(7), w(0))[0][0].numpy()) == 0
    assert pw.to_int(pw.sdiv(w(1 << 255), w(M256))[0].numpy()) == 1 << 255
    assert pw.to_int(pw.shl(w(256), w(1))[0].numpy()) == 0
    assert pw.to_int(pw.sar(w(300), w(1 << 255))[0].numpy()) == M256
    assert pw.to_int(pw.byte_word(w(32), w(M256))[0].numpy()) == 0
    assert pw.to_int(pw.signextend(w(31), w(0x80))[0].numpy()) == 0x80
    assert pw.to_int(pw.signextend(w(0), w(0x80))[0].numpy()) == M256 - 0x7F


def test_byte_conversions_round_trip():
    a = EDGE + _vals(7, 16)
    p = _port(a)
    assert torch.equal(pw.from_bytes_be(pw.to_bytes_be(p)), p)
    assert _same(rw.to_bytes_be(_ref(a)), pw.to_bytes_be(p))
