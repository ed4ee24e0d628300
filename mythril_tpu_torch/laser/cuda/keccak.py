"""Batched Keccak-256: the device kernel (K2) and its plain PyTorch twin.

Replaces ``mythril_tpu/laser/tpu/keccak_tpu.py`` (``keccak_f`` and
``keccak256_batch``). Input is a byte buffer ``u8[..., N]`` with a
per-row byte length; the padding (0x01 at ``length``, 0x80 OR-ed into
the last byte of the last block) and the absorb of up to ``max_blocks``
136-byte blocks happen inside the function, exactly as in the
reference, including what it does when a message does not fit.

Kernel (``csrc/keccak.cu``, ``csrc/keccak.cuh``): one thread per row,
the 25-lane state in 64-bit registers. Bound on the H100: bytes — each
row reads its N input bytes once and writes 32; the permutation is
about 24 x 25 x ~10 integer ops per block, far under the card's integer
rate at the main path's sizes. The same ``keccak_f`` device function
is inlined into the step kernel (K1) for SHA3.

The twin keeps each 64-bit lane as a (lo, hi) pair of u32 values held
in int64, as the reference does; ``>>`` on int64 is arithmetic, so
every right shift works on values already masked to 32 bits.
"""

import ctypes

import numpy as np
import torch

from mythril_tpu_torch.laser.cuda import _build

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

launches = 0  # K2 launches (CUDA path only)


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


def keccak256_batch(data: torch.Tensor, length: torch.Tensor, max_blocks: int = None, device="cuda") -> torch.Tensor:
    """Keccak-256 of each row of ``data`` u8[..., N] over its ``length``.

    On the CPU this is the plain twin; on the card it launches K2."""
    _build.check_on(device, data, length)
    if data.device.type == "cpu":
        return keccak256_plain(data, length, max_blocks)
    n = data.shape[-1]
    if max_blocks is None:
        max_blocks = default_max_blocks(n)
    if data.dtype != torch.uint8:
        raise TypeError("keccak256_batch wants uint8 data")
    batch_shape = data.shape[:-1]
    rows = int(np.prod(batch_shape)) if batch_shape else 1
    d = data.reshape(rows, n).contiguous()
    ln = length.reshape(rows).to(torch.int32).contiguous()
    out = torch.empty((rows, 32), dtype=torch.uint8, device=data.device)
    _launch(d, n, None, None, ln, None, out, rows, n, max_blocks, None)
    return out.reshape(batch_shape + (32,))


def _launch(base, stride, off, avail, length, active, out, rows, n, max_blocks, ctl):
    global launches
    lib = _build.library("keccak")
    fn = lib.mt_keccak256_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    vp = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)  # noqa: E731
    launches += 1
    rc = fn(vp(base), stride, vp(off), vp(avail), vp(length), vp(active), vp(out), rows, n,
            max_blocks, vp(ctl), _build.stream(base.device))
    _build.check(rc, "keccak256", "keccak")


# The step's concrete SHA3 (reference engine.py:782-793): each running
# lane at a non-trapping SHA3 hashes min(b32, SHA_CAP) bytes of its
# memory from a32, with N = SHA_CAP as the reference's buffer width.
SHA_CAP = 544


def keccak256_window_plain(plane, off, avail, length, max_blocks=None):
    """Twin of the window form: row r hashes plane[r, off[r]:][:avail[r]]
    (zero past avail) over length[r] bytes, N = SHA_CAP."""
    L, M = plane.shape
    j = torch.arange(SHA_CAP, device=plane.device)
    idx = off.to(torch.int64)[:, None] + j[None, :]
    ok = j[None, :] < avail.to(torch.int64)[:, None]
    rows = torch.arange(L, device=plane.device)[:, None]
    data = torch.where(ok, plane[rows, idx.clamp(0, M - 1)], 0).to(torch.uint8)
    return keccak256_plain(data, length, max_blocks)


def keccak256_window(plane, off, avail, length, active, out, ctl=None):
    """K2 over windows of a lane-major byte plane (the step's SHA3 path);
    rows with ``active`` 0 keep their ``out`` row."""
    if plane.device.type == "cpu":
        dig = keccak256_window_plain(plane, off, avail, length)
        out[active.bool()] = dig[active.bool()]
        return out
    L, M = plane.shape
    _launch(plane, M, off, avail, length, active, out, L, SHA_CAP,
            default_max_blocks(SHA_CAP), ctl)
    return out
