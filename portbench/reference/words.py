"""Frozen copy of ``mythril_tpu_torch/laser/cuda/words.py`` (imports pointed at this package).

256-bit EVM word arithmetic: the plain PyTorch twin of the device code.

Counterpart of ``mythril_tpu/laser/tpu/words.py``. A word is 16 LSB-first
16-bit digits along the last axis, as in the reference. The reference
holds digits in u32 lanes; this twin holds them in ``torch.int64`` so
that every add, product and compare is defined on the CPU (torch's CPU
``uint32`` has no arithmetic), and digit products (< 2^32) never
overflow. At the ``StateBatch`` boundary word planes are int32 tensors
holding the reference's u32 bits (digits < 2^16, so the values are
equal); ``from_plane``/``to_plane`` convert.

The CUDA side of the same arithmetic is ``csrc/words.cuh``, inlined into
the step kernel. Both follow EVM semantics: DIV/MOD by zero is 0, SDIV
-2^255 / -1 wraps, EXP is mod 2^256, shifts >= 256 give 0 (or the sign
fill for SAR).
"""

from typing import Tuple

import numpy as np
import torch

NDIGITS = 16
DIGIT_BITS = 16
DIGIT_MASK = 0xFFFF
I64 = torch.int64


# ---------------------------------------------------------------------------
# host helpers


def from_int(x: int, dtype=np.uint32) -> np.ndarray:
    """Python int -> digit vector (host helper)."""
    x &= (1 << 256) - 1
    return np.array([(x >> (DIGIT_BITS * i)) & 0xFFFF for i in range(NDIGITS)], dtype=dtype)


def to_int(w) -> int:
    """Digit vector -> python int (host helper)."""
    w = np.asarray(w)
    return sum(int(w[..., i]) << (DIGIT_BITS * i) for i in range(NDIGITS))


def from_plane(x: torch.Tensor) -> torch.Tensor:
    """int32 plane holding u32 digits -> int64 digits."""
    return x.to(I64) & 0xFFFFFFFF


def to_plane(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 plane with the same bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """u32 values (int64) -> word occupying digits 0..1."""
    x = x.to(I64) & 0xFFFFFFFF
    out = torch.zeros(x.shape + (NDIGITS,), dtype=I64, device=x.device)
    out[..., 0] = x & DIGIT_MASK
    out[..., 1] = x >> DIGIT_BITS
    return out


def to_u32(w: torch.Tensor) -> torch.Tensor:
    return w[..., 0] | (w[..., 1] << DIGIT_BITS)


def fits_u32(w: torch.Tensor) -> torch.Tensor:
    return (w[..., 2:] == 0).all(dim=-1)


def from_bytes_be(b: torch.Tensor) -> torch.Tensor:
    """[..., 32] big-endian bytes -> word."""
    b = b.to(I64).flip(-1)
    return b[..., 0::2] | (b[..., 1::2] << 8)


def to_bytes_be(w: torch.Tensor) -> torch.Tensor:
    """word -> [..., 32] big-endian byte values (int64)."""
    lo = w & 0xFF
    hi = (w >> 8) & 0xFF
    return torch.stack([lo, hi], dim=-1).reshape(w.shape[:-1] + (32,)).flip(-1)


def bit_not(a):
    return (~a) & DIGIT_MASK


# ---------------------------------------------------------------------------
# add / sub / compare


def _ripple(cols):
    """Carry-propagate [..., n] column sums; returns (digits, carry)."""
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[..., 0])
    for i in range(cols.shape[-1]):
        t = cols[..., i] + carry
        out[..., i] = t & DIGIT_MASK
        carry = t >> DIGIT_BITS
    return out, carry


def add(a, b):
    return _ripple(a + b)[0]


def add_carry(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    return _ripple(a + b)


def sub_borrow(a, b):
    cols = a + (DIGIT_MASK - b)
    cols[..., 0] += 1
    r, carry = _ripple(cols)
    return r, carry == 0


def sub(a, b):
    return sub_borrow(a, b)[0]


def neg(a):
    return sub(torch.zeros_like(a), a)


def ult(a, b):
    return sub_borrow(a, b)[1]


def ugt(a, b):
    return ult(b, a)


def uge(a, b):
    return ~ult(a, b)


def _flip_sign(a):
    out = a.clone()
    out[..., NDIGITS - 1] ^= 0x8000
    return out


def slt(a, b):
    return ult(_flip_sign(a), _flip_sign(b))


def sgt(a, b):
    return slt(b, a)


def eq(a, b):
    return (a == b).all(dim=-1)


def is_zero(a):
    return (a == 0).all(dim=-1)


def bool_to_word(m):
    w = torch.zeros(m.shape + (NDIGITS,), dtype=I64, device=m.device)
    w[..., 0] = m.to(I64)
    return w


def sign_bit(a):
    return (a[..., NDIGITS - 1] >> 15) & 1


# ---------------------------------------------------------------------------
# multiplication


def mul_full(a, b):
    """Full 512-bit product as [..., 32] digits."""
    prod = a[..., :, None] * b[..., None, :]  # [..., 16, 16], each < 2^32
    lo = prod & DIGIT_MASK
    hi = prod >> DIGIT_BITS
    cols = torch.zeros(a.shape[:-1] + (2 * NDIGITS,), dtype=I64, device=a.device)
    for i in range(NDIGITS):
        cols[..., i : i + NDIGITS] += lo[..., i, :]
        cols[..., i + 1 : i + 1 + NDIGITS] += hi[..., i, :]
    return _ripple(cols)[0]


def mul(a, b):
    return mul_full(a, b)[..., :NDIGITS]


# ---------------------------------------------------------------------------
# division (shift-subtract long division)


def _divmod_wide(dividend, divisor, nbits: int):
    """dividend [..., D] digits (D*16 >= nbits), divisor word -> (quot, rem)."""
    quot = torch.zeros_like(dividend)
    rem = torch.zeros(dividend.shape[:-1] + (NDIGITS,), dtype=I64, device=dividend.device)
    for i in range(nbits):
        bit_index = nbits - 1 - i
        d, r = divmod(bit_index, DIGIT_BITS)
        bit = (dividend[..., d] >> r) & 1
        rem_hi = rem >> (DIGIT_BITS - 1)
        overflow = rem_hi[..., -1] == 1
        rem = (rem << 1) & DIGIT_MASK
        rem[..., 0] += bit
        rem[..., 1:] += rem_hi[..., :-1]
        ge = overflow | uge(rem, divisor)
        rem = torch.where(ge[..., None], sub(rem, divisor), rem)
        quot[..., d] += ge.to(I64) << r
    return quot, rem


def divmod256(a, b):
    q, r = _divmod_wide(a, b, 256)
    bz = is_zero(b)[..., None]
    return torch.where(bz, 0, q), torch.where(bz, 0, r)


def abs_signed(a):
    negm = sign_bit(a) == 1
    return torch.where(negm[..., None], neg(a), a), negm


def sdiv(a, b):
    aa, an = abs_signed(a)
    bb, bn = abs_signed(b)
    q = divmod256(aa, bb)[0]
    return torch.where((an ^ bn)[..., None], neg(q), q)


def smod(a, b):
    aa, an = abs_signed(a)
    bb, _ = abs_signed(b)
    r = divmod256(aa, bb)[1]
    return torch.where(an[..., None], neg(r), r)


def addmod(a, b, n):
    s, carry = add_carry(a, b)
    wide = torch.cat([s, carry[..., None], torch.zeros_like(s[..., 1:])], dim=-1)
    _, r = _divmod_wide(wide, n, 257)
    return torch.where(is_zero(n)[..., None], 0, r)


def mulmod(a, b, n):
    _, r = _divmod_wide(mul_full(a, b), n, 512)
    return torch.where(is_zero(n)[..., None], 0, r)


def exp(a, e):
    result = torch.zeros_like(a)
    result[..., 0] = 1
    base = a
    for i in range(256):
        d, r = divmod(i, DIGIT_BITS)
        bit = (e[..., d] >> r) & 1
        result = torch.where((bit == 1)[..., None], mul(result, base), result)
        base = mul(base, base)
    return result


# ---------------------------------------------------------------------------
# shifts, byte, signextend


def _shift_amount(s):
    over = ~fits_u32(s) | (to_u32(s) >= 256)
    amt = to_u32(s) & 0xFF
    return amt // DIGIT_BITS, amt % DIGIT_BITS, over


def _gather_digits(src, idx):
    return torch.gather(src, -1, idx.clamp(0, src.shape[-1] - 1))


def shl(s, a):
    d, r, over = _shift_amount(s)
    k = torch.arange(NDIGITS, device=a.device)
    idx1 = k - d[..., None]
    idx2 = idx1 - 1
    a1 = torch.where(idx1 >= 0, _gather_digits(a, idx1), 0)
    a2 = torch.where(idx2 >= 0, _gather_digits(a, idx2), 0)
    res = ((a1 << r[..., None]) | (a2 >> (DIGIT_BITS - r[..., None]))) & DIGIT_MASK
    return torch.where(over[..., None], 0, res)


def shr(s, a):
    d, r, over = _shift_amount(s)
    k = torch.arange(NDIGITS, device=a.device)
    idx1 = k + d[..., None]
    idx2 = idx1 + 1
    a1 = torch.where(idx1 < NDIGITS, _gather_digits(a, idx1), 0)
    a2 = torch.where(idx2 < NDIGITS, _gather_digits(a, idx2), 0)
    res = ((a1 >> r[..., None]) | (a2 << (DIGIT_BITS - r[..., None]))) & DIGIT_MASK
    return torch.where(over[..., None], 0, res)


def sar(s, a):
    negm = sign_bit(a) == 1
    fill = torch.where(negm[..., None], torch.full_like(a, DIGIT_MASK), torch.zeros_like(a))
    d, r, over = _shift_amount(s)
    k = torch.arange(NDIGITS, device=a.device)
    idx1 = k + d[..., None]
    ext = torch.cat([a, fill], dim=-1)
    a1 = _gather_digits(ext, idx1)
    a2 = _gather_digits(ext, idx1 + 1)
    res = ((a1 >> r[..., None]) | (a2 << (DIGIT_BITS - r[..., None]))) & DIGIT_MASK
    return torch.where(over[..., None], fill, res)


def byte_word(i, w):
    iv = to_u32(i)
    valid = fits_u32(i) & (iv < 32)
    pos = (31 - iv.clamp(0, 31)) * 8
    digit = torch.gather(w, -1, (pos // DIGIT_BITS)[..., None])[..., 0]
    byte = torch.where(valid, (digit >> (pos % DIGIT_BITS)) & 0xFF, 0)
    out = torch.zeros_like(w)
    out[..., 0] = byte
    return out


def signextend(b, x):
    bv = to_u32(b)
    valid = fits_u32(b) & (bv < 31)
    sign_pos = (bv * 8 + 7) & 0xFFFFFFFF
    digit = torch.gather(x, -1, (sign_pos // DIGIT_BITS).clamp(0, NDIGITS - 1)[..., None])[..., 0]
    sbit = (digit >> (sign_pos % DIGIT_BITS)) & 1
    k = torch.arange(NDIGITS, device=x.device)
    live = (sign_pos[..., None] + 1 - DIGIT_BITS * k).clamp(0, DIGIT_BITS)
    mask = torch.where(live >= DIGIT_BITS, DIGIT_MASK, (1 << live) - 1)
    ext = torch.where((sbit == 1)[..., None], (x & mask) | (DIGIT_MASK & ~mask), x & mask)
    return torch.where(valid[..., None], ext, x)
