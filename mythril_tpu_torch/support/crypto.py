"""Cryptographic primitives for the EVM precompiles, implemented in-repo.

The reference pulls these from pip wheels (ethereum.utils.ecrecover_to_pub,
py_ecc.optimized_bn128, the blake2b package — see mythril/laser/ethereum/
natives.py:5-10); none of those are available here, so the math lives in
this module. Everything is concrete-only (precompiles bail to symbolic
outputs on symbolic inputs, matching the reference's NativeContractException
flow)."""

import hashlib
from typing import List, Optional, Tuple

from mythril_tpu_torch.support.keccak import keccak256

# ---------------------------------------------------------------------------
# secp256k1 / ecrecover

_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _ec_add(p1, p2, p_mod):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % p_mod == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, p_mod) % p_mod
    else:
        lam = (y2 - y1) * _inv(x2 - x1, p_mod) % p_mod
    x3 = (lam * lam - x1 - x2) % p_mod
    y3 = (lam * (x1 - x3) - y1) % p_mod
    return (x3, y3)


def _ec_mul(point, scalar: int, p_mod):
    result = None
    addend = point
    while scalar:
        if scalar & 1:
            result = _ec_add(result, addend, p_mod)
        addend = _ec_add(addend, addend, p_mod)
        scalar >>= 1
    return result


def ecrecover_to_pub(msg_hash: bytes, v: int, r: int, s: int) -> bytes:
    """Recover the 64-byte public key from a signature (precompile 0x1)."""
    if v not in (27, 28):
        raise ValueError("invalid v")
    if not (1 <= r < _N) or not (1 <= s < _N):
        raise ValueError("invalid r/s")
    x = r
    alpha = (pow(x, 3, _P) + 7) % _P
    beta = pow(alpha, (_P + 1) // 4, _P)
    y = beta if (beta % 2 == 0) == (v == 27) else _P - beta
    if (y * y - alpha) % _P != 0:
        raise ValueError("invalid signature point")
    z = int.from_bytes(msg_hash, "big")
    r_inv = _inv(r, _N)
    R = (x, y)
    u1 = (-z * r_inv) % _N
    u2 = (s * r_inv) % _N
    q = _ec_add(_ec_mul((_GX, _GY), u1, _P), _ec_mul(R, u2, _P), _P)
    if q is None:
        raise ValueError("recovered point at infinity")
    return q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")


def ecrecover_to_address(msg_hash: bytes, v: int, r: int, s: int) -> int:
    pub = ecrecover_to_pub(msg_hash, v, r, s)
    return int.from_bytes(keccak256(pub)[12:], "big")


# ---------------------------------------------------------------------------
# alt_bn128 (precompiles 0x6 ecAdd / 0x7 ecMul; pairing in bn128_pairing.py)

BN128_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN128_N = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def _bn128_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + 3)) % BN128_P == 0


def bn128_add(p1: Optional[Tuple[int, int]], p2: Optional[Tuple[int, int]]):
    for pt in (p1, p2):
        if not _bn128_is_on_curve(pt):
            raise ValueError("point not on bn128 curve")
    return _ec_add(p1, p2, BN128_P)


def bn128_mul(pt: Optional[Tuple[int, int]], scalar: int):
    if not _bn128_is_on_curve(pt):
        raise ValueError("point not on bn128 curve")
    if pt is None:
        return None
    return _ec_mul(pt, scalar % BN128_N, BN128_P)


def validate_bn128_point(x: int, y: int) -> Optional[Tuple[int, int]]:
    """Decode an (x, y) precompile input point; (0,0) is infinity."""
    if x >= BN128_P or y >= BN128_P:
        raise ValueError("bn128 coordinate out of range")
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not _bn128_is_on_curve(pt):
        raise ValueError("point not on bn128 curve")
    return pt


# ---------------------------------------------------------------------------
# ripemd160 (hashlib may lack it under OpenSSL 3; pure fallback below)


def ripemd160(data: bytes) -> bytes:
    try:
        h = hashlib.new("ripemd160")
        h.update(data)
        return h.digest()
    except ValueError:
        return _ripemd160_py(data)


_RMD_R1 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
           7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
           3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
           1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
           4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13]
_RMD_R2 = [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
           6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
           15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
           8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
           12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11]
_RMD_S1 = [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
           7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
           11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
           11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
           9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6]
_RMD_S2 = [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
           9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
           9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
           15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
           8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11]


def _rmd_f(j: int, x: int, y: int, z: int) -> int:
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | (~x & z)
    if j < 48:
        return (x | ~y) ^ z
    if j < 64:
        return (x & z) | (y & ~z)
    return x ^ (y | ~z)


_RMD_K1 = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_RMD_K2 = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]


def _rol(x, n):
    x &= 0xFFFFFFFF
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _ripemd160_py(data: bytes) -> bytes:
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    padded = bytearray(data)
    bitlen = len(data) * 8
    padded.append(0x80)
    while len(padded) % 64 != 56:
        padded.append(0)
    padded += bitlen.to_bytes(8, "little")
    for off in range(0, len(padded), 64):
        x = [int.from_bytes(padded[off + 4 * i : off + 4 * i + 4], "little") for i in range(16)]
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            t = _rol(al + _rmd_f(j, bl, cl, dl) + x[_RMD_R1[j]] + _RMD_K1[j // 16], _RMD_S1[j]) + el
            al, el, dl, cl, bl = el, dl, _rol(cl, 10), bl, t & 0xFFFFFFFF
            t = _rol(ar + _rmd_f(79 - j, br, cr, dr) + x[_RMD_R2[j]] + _RMD_K2[j // 16], _RMD_S2[j]) + er
            ar, er, dr, cr, br = er, dr, _rol(cr, 10), br, t & 0xFFFFFFFF
        t = (h[1] + cl + dr) & 0xFFFFFFFF
        h[1] = (h[2] + dl + er) & 0xFFFFFFFF
        h[2] = (h[3] + el + ar) & 0xFFFFFFFF
        h[3] = (h[4] + al + br) & 0xFFFFFFFF
        h[4] = (h[0] + bl + cr) & 0xFFFFFFFF
        h[0] = t
    return b"".join(v.to_bytes(4, "little") for v in h)


# ---------------------------------------------------------------------------
# blake2b F compression (EIP-152, precompile 0x9)

_B2B_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

_B2B_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

_M64 = (1 << 64) - 1


def _rotr64(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & _M64


def blake2b_compress(rounds: int, h: List[int], m: List[int], t: Tuple[int, int], final: bool) -> List[int]:
    """The raw blake2b F function with a configurable round count."""
    v = h[:] + _B2B_IV[:]
    v[12] ^= t[0]
    v[13] ^= t[1]
    if final:
        v[14] ^= _M64

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _M64
        v[d] = _rotr64(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & _M64
        v[b] = _rotr64(v[b] ^ v[c], 24)
        v[a] = (v[a] + v[b] + y) & _M64
        v[d] = _rotr64(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _M64
        v[b] = _rotr64(v[b] ^ v[c], 63)

    for r in range(rounds):
        s = _B2B_SIGMA[r % 10]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])

    return [(h[i] ^ v[i] ^ v[i + 8]) & _M64 for i in range(8)]
