"""Frozen copy of the port's plain Keccak-256 twin (``keccak256_plain``).

Copied from ``mythril_tpu_torch/laser/cuda/keccak.py``, CUDA launch left
out. Input is a byte buffer ``u8[..., N]`` with a per-row byte length;
the padding and the absorb of up to ``max_blocks`` 136-byte blocks
happen inside, as in the program. Each 64-bit lane is a (lo, hi) pair of
u32 values held in int64; every right shift works on values already
masked to 32 bits.
"""

import numpy as np
import torch


RATE = 136
RATE_LANES = RATE // 8
M32 = 0xFFFFFFFF

_RHO = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14]
_PI_DST = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _PI_DST[_x + 5 * _y] = _y + 5 * ((2 * _x + 3 * _y) % 5)
_PI_SRC_FOR_DST = np.argsort(_PI_DST)
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_X_MINUS_1 = [(x - 1) % 5 for x in range(5)]
_X_PLUS_1 = [(x + 1) % 5 for x in range(5)]


def _rotl64(lo, hi, n):
    """Rotate (lo, hi) u32 pairs left by n (python int or [..., k] tensor)."""
    n = torch.as_tensor(n, dtype=torch.int64, device=lo.device)
    swap = n >= 32
    l0 = torch.where(swap, hi, lo)
    h0 = torch.where(swap, lo, hi)
    m = torch.where(swap, n - 32, n)
    inv = (32 - m) % 32  # m == 0 is masked below
    new_lo = torch.where(m == 0, l0, ((l0 << m) | (h0 >> inv)) & M32)
    new_hi = torch.where(m == 0, h0, ((h0 << m) | (l0 >> inv)) & M32)
    return new_lo, new_hi


def keccak_f(lo, hi):
    """keccak-f[1600] on (lo, hi) int64 tensors of shape [..., 25]."""
    dev = lo.device
    rho = torch.as_tensor(_RHO, dtype=torch.int64, device=dev)
    pi_src = torch.as_tensor(_PI_SRC_FOR_DST, device=dev)
    for rnd in range(24):
        g = lo.reshape(lo.shape[:-1] + (5, 5))
        gh = hi.reshape(hi.shape[:-1] + (5, 5))
        c_lo = g[..., 0, :] ^ g[..., 1, :] ^ g[..., 2, :] ^ g[..., 3, :] ^ g[..., 4, :]
        c_hi = gh[..., 0, :] ^ gh[..., 1, :] ^ gh[..., 2, :] ^ gh[..., 3, :] ^ gh[..., 4, :]
        r_lo, r_hi = _rotl64(c_lo[..., _X_PLUS_1], c_hi[..., _X_PLUS_1], 1)
        d_lo = c_lo[..., _X_MINUS_1] ^ r_lo
        d_hi = c_hi[..., _X_MINUS_1] ^ r_hi
        lo = (g ^ d_lo[..., None, :]).reshape(lo.shape)
        hi = (gh ^ d_hi[..., None, :]).reshape(hi.shape)
        lo, hi = _rotl64(lo, hi, rho)
        lo = lo[..., pi_src]
        hi = hi[..., pi_src]
        bl = lo.reshape(lo.shape[:-1] + (5, 5))
        bh = hi.reshape(hi.shape[:-1] + (5, 5))
        lo = (bl ^ (~torch.roll(bl, -1, -1) & torch.roll(bl, -2, -1)) & M32).reshape(lo.shape)
        hi = (bh ^ (~torch.roll(bh, -1, -1) & torch.roll(bh, -2, -1)) & M32).reshape(hi.shape)
        lo = lo.clone()
        hi = hi.clone()
        lo[..., 0] ^= _RC[rnd] & M32
        hi[..., 0] ^= _RC[rnd] >> 32
    return lo, hi


def default_max_blocks(n: int) -> int:
    return (n + 1 + RATE - 1) // RATE


def keccak256_plain(data: torch.Tensor, length: torch.Tensor, max_blocks: int = None) -> torch.Tensor:
    """Plain PyTorch twin: u8[..., N] + int length -> u8[..., 32]."""
    n = data.shape[-1]
    if max_blocks is None:
        max_blocks = default_max_blocks(n)
    cap = max_blocks * RATE
    batch_shape = data.shape[:-1]
    dev = data.device
    length = length.to(torch.int64)
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    padded = torch.zeros(batch_shape + (cap,), dtype=torch.int64, device=dev)
    w = min(n, cap)
    padded[..., :w] = data[..., :w].to(torch.int64)
    L = length[..., None]
    msg = torch.where(idx < L, padded, 0)
    msg = msg | torch.where(idx == L, 0x01, 0)
    nblocks = torch.div(length + 1 + RATE - 1, RATE, rounding_mode="floor")
    last = nblocks * RATE - 1
    msg = msg | torch.where(idx == last[..., None], 0x80, 0)

    lo = torch.zeros(batch_shape + (25,), dtype=torch.int64, device=dev)
    hi = torch.zeros_like(lo)
    for b in range(max_blocks):
        blk = msg[..., b * RATE : (b + 1) * RATE].reshape(batch_shape + (RATE_LANES, 8))
        blo = blk[..., 0] | (blk[..., 1] << 8) | (blk[..., 2] << 16) | (blk[..., 3] << 24)
        bhi = blk[..., 4] | (blk[..., 5] << 8) | (blk[..., 6] << 16) | (blk[..., 7] << 24)
        xlo = lo.clone()
        xhi = hi.clone()
        xlo[..., :RATE_LANES] ^= blo
        xhi[..., :RATE_LANES] ^= bhi
        nlo, nhi = keccak_f(xlo, xhi)
        take = (b < nblocks)[..., None]
        lo = torch.where(take, nlo, lo)
        hi = torch.where(take, nhi, hi)

    shifts = torch.arange(4, dtype=torch.int64, device=dev) * 8
    lo_b = (lo[..., :4, None] >> shifts) & 0xFF
    hi_b = (hi[..., :4, None] >> shifts) & 0xFF
    out = torch.cat([lo_b, hi_b], dim=-1).reshape(batch_shape + (32,))
    return out.to(torch.uint8)
