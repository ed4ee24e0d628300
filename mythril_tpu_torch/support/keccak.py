"""Keccak-256 (Ethereum flavor, pre-NIST padding 0x01).

Replaces the reference's `_pysha3` C extension (mythril/support/support_utils.py:4)
and `ethereum.utils.sha3` (keccak_function_manager.py:49). Three engines:

- native C++ (mythril_tpu_torch/csrc/native.cpp, loaded via ctypes) — default host path
- pure Python fallback (below)
- the batched device kernel K2 for hashing many inputs on the card
  (mythril_tpu_torch/laser/cuda/keccak.py)
"""

from typing import Optional

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state):
    for rnd in range(24):
        # theta
        c = [state[x][0] ^ state[x][1] ^ state[x][2] ^ state[x][3] ^ state[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(state[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                state[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        state[0][0] ^= _RC[rnd]
    return state


def _keccak256_py(data: bytes) -> bytes:
    rate = 136
    # pad10*1 with the 0x01 domain byte (original Keccak, as used by Ethereum)
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80

    state = [[0] * 5 for _ in range(5)]
    for block_start in range(0, len(padded), rate):
        block = padded[block_start : block_start + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[i * 8 : (i + 1) * 8], "little")
            state[i % 5][i // 5] ^= lane
        _keccak_f(state)

    out = bytearray()
    for i in range(4):  # 32 bytes = 4 lanes
        out += state[i % 5][i // 5].to_bytes(8, "little")
    return bytes(out)


_native_keccak: Optional[object] = None
_native_checked = False


def _get_native():
    global _native_keccak, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from mythril_tpu_torch.support.native_build import load_native_lib
            import ctypes

            lib = load_native_lib()
            if lib is not None:
                lib.mtpu_keccak256.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_size_t,
                    ctypes.c_char_p,
                ]
                lib.mtpu_keccak256.restype = None
                _native_keccak = lib.mtpu_keccak256
        except Exception:
            _native_keccak = None
    return _native_keccak


def keccak256(data: bytes) -> bytes:
    """keccak256 of a byte string."""
    if isinstance(data, str):
        data = data.encode()
    fn = _get_native()
    if fn is not None:
        import ctypes

        out = ctypes.create_string_buffer(32)
        fn(bytes(data), len(data), out)
        return out.raw
    return _keccak256_py(bytes(data))
