"""alt_bn128 (BN254) optimal-ate pairing check — EIP-197 precompile 0x8.

The reference delegates to py_ecc.optimized_bn128
(mythril/laser/ethereum/natives.py:138-196); this is an in-repo
implementation built on an Fp2 / Fp6 / Fp12 extension tower:

    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = 9 + u
    Fp12 = Fp6[w] / (w^2 - v)

G2 points live on the D-twist E'/Fp2: y^2 = x^3 + 3/xi and are mapped into
E/Fp12 by psi(x, y) = (x*w^2, y*w^3). The Miller loop runs the optimal-ate
length 6x+2 (x = 4965661367192848881) in plain affine Fp12 arithmetic —
clarity over speed; the precompile is rare in symbolic execution, and
multi-pair inputs share a single final exponentiation. Frobenius on twist
points uses constants computed at import time (xi^((p-1)/3), xi^((p-1)/2)),
so there are no opaque magic numbers.

Correctness anchors: bilinearity self-tests in
tests/support/test_bn128_pairing.py (e(P,Q)*e(-P,Q) == 1 etc.) mirroring
the reference's tests/laser/Precompiles pairing vectors.
"""

from typing import Optional, Tuple

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BN_X = 4965661367192848881
ATE_LOOP = 6 * BN_X + 2

Fp2 = Tuple[int, int]  # a0 + a1*u
Fp6 = Tuple[Fp2, Fp2, Fp2]
Fp12 = Tuple[Fp6, Fp6]

XI: Fp2 = (9, 1)

# ---------------------------------------------------------------------- Fp2

F2_ZERO: Fp2 = (0, 0)
F2_ONE: Fp2 = (1, 0)


def f2_add(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a: Fp2) -> Fp2:
    return (-a[0] % P, -a[1] % P)


def f2_mul(a: Fp2, b: Fp2) -> Fp2:
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_sqr(a: Fp2) -> Fp2:
    return f2_mul(a, a)


def f2_scalar(a: Fp2, k: int) -> Fp2:
    return (a[0] * k % P, a[1] * k % P)


def f2_conj(a: Fp2) -> Fp2:
    return (a[0], -a[1] % P)


def f2_inv(a: Fp2) -> Fp2:
    d = pow(a[0] * a[0] + a[1] * a[1], P - 2, P)
    return (a[0] * d % P, -a[1] * d % P)


def f2_pow(a: Fp2, e: int) -> Fp2:
    out = F2_ONE
    base = a
    while e:
        if e & 1:
            out = f2_mul(out, base)
        base = f2_sqr(base)
        e >>= 1
    return out


# frobenius constants on the twist: sigma(x, y) = (conj(x)*G2C_X, conj(y)*G2C_Y)
G2C_X = f2_pow(XI, (P - 1) // 3)
G2C_Y = f2_pow(XI, (P - 1) // 2)

# ---------------------------------------------------------------------- Fp6

F6_ZERO: Fp6 = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE: Fp6 = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a: Fp6, b: Fp6) -> Fp6:
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a: Fp6, b: Fp6) -> Fp6:
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a: Fp6) -> Fp6:
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a: Fp6, b: Fp6) -> Fp6:
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_add(f2_mul(a0, b1), f2_mul(a1, b0))
    t2 = f2_add(f2_mul(a0, b2), f2_add(f2_mul(a1, b1), f2_mul(a2, b0)))
    t3 = f2_add(f2_mul(a1, b2), f2_mul(a2, b1))
    t4 = f2_mul(a2, b2)
    # reduce v^3 = xi
    return (
        f2_add(t0, f2_mul(XI, t3)),
        f2_add(t1, f2_mul(XI, t4)),
        t2,
    )


def f6_mul_by_v(a: Fp6) -> Fp6:
    # v * (a0 + a1 v + a2 v^2) = xi*a2 + a0 v + a1 v^2
    return (f2_mul(XI, a[2]), a[0], a[1])


def f6_inv(a: Fp6) -> Fp6:
    a0, a1, a2 = a
    A = f2_sub(f2_sqr(a0), f2_mul(XI, f2_mul(a1, a2)))
    B = f2_sub(f2_mul(XI, f2_sqr(a2)), f2_mul(a0, a1))
    C = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    F = f2_add(
        f2_mul(a0, A),
        f2_mul(XI, f2_add(f2_mul(a1, C), f2_mul(a2, B))),
    )
    Finv = f2_inv(F)
    return (f2_mul(A, Finv), f2_mul(B, Finv), f2_mul(C, Finv))


# --------------------------------------------------------------------- Fp12

F12_ONE: Fp12 = (F6_ONE, F6_ZERO)


def f12_mul(a: Fp12, b: Fp12) -> Fp12:
    d0, d1 = a
    e0, e1 = b
    t0 = f6_mul(d0, e0)
    t1 = f6_add(f6_mul(d0, e1), f6_mul(d1, e0))
    t2 = f6_mul(d1, e1)
    return (f6_add(t0, f6_mul_by_v(t2)), t1)


def f12_sqr(a: Fp12) -> Fp12:
    return f12_mul(a, a)


def f12_sub(a: Fp12, b: Fp12) -> Fp12:
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_neg_w(a: Fp12) -> Fp12:
    return (a[0], f6_neg(a[1]))


def f12_inv(a: Fp12) -> Fp12:
    d0, d1 = a
    # (d0 + d1 w)^-1 = (d0 - d1 w) / (d0^2 - v d1^2)
    denom = f6_sub(f6_mul(d0, d0), f6_mul_by_v(f6_mul(d1, d1)))
    dinv = f6_inv(denom)
    return (f6_mul(d0, dinv), f6_neg(f6_mul(d1, dinv)))


def f12_pow(a: Fp12, e: int) -> Fp12:
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_sqr(base)
        e >>= 1
    return out


def f12_from_fp(x: int) -> Fp12:
    return (((x % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def f12_from_fp2(x: Fp2) -> Fp12:
    return ((x, F2_ZERO, F2_ZERO), F6_ZERO)


# w^2 = v, w^3 = v*w as Fp12 constants (for the twist embedding)
W2: Fp12 = ((F2_ZERO, F2_ONE, F2_ZERO), F6_ZERO)
W3: Fp12 = (F6_ZERO, (F2_ZERO, F2_ONE, F2_ZERO))


# ----------------------------------------------------------------- G1 / G2

G1Point = Optional[Tuple[int, int]]  # None = infinity
G2Point = Optional[Tuple[Fp2, Fp2]]

# b' = 3 / xi for the D-twist E': y^2 = x^3 + b'
TWIST_B: Fp2 = f2_mul((3, 0), f2_inv(XI))


def g1_on_curve(pt: G1Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + 3)) % P == 0


def g2_on_curve(pt: G2Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = f2_sqr(y)
    rhs = f2_add(f2_mul(f2_sqr(x), x), TWIST_B)
    return lhs == rhs


def g2_neg(pt: G2Point) -> G2Point:
    if pt is None:
        return None
    return (pt[0], f2_neg(pt[1]))


def g2_add(p1: G2Point, p2: G2Point) -> G2Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == f2_neg(y2):
            return None
        lam = f2_mul(
            f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2))
        )
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(pt: G2Point, k: int) -> G2Point:
    out: G2Point = None
    add = pt
    while k:
        if k & 1:
            out = g2_add(out, add)
        add = g2_add(add, add)
        k >>= 1
    return out


def g2_frobenius(pt: G2Point) -> G2Point:
    """sigma(x, y) = (conj(x)*xi^((p-1)/3), conj(y)*xi^((p-1)/2)): the image
    of the p-power Frobenius pulled back through the twist embedding."""
    if pt is None:
        return None
    x, y = pt
    return (f2_mul(f2_conj(x), G2C_X), f2_mul(f2_conj(y), G2C_Y))


# -------------------------------------------------------------- Miller loop


def _psi(pt: G2Point) -> Tuple[Fp12, Fp12]:
    """Twist embedding into E/Fp12."""
    x, y = pt
    return f12_mul(f12_from_fp2(x), W2), f12_mul(f12_from_fp2(y), W3)


def _line(t_xy, q_xy, p_xy) -> Tuple[Fp12, Tuple[Fp12, Fp12]]:
    """Chord/tangent line through t, q (Fp12 points) evaluated at p;
    returns (line value, t+q)."""
    x1, y1 = t_xy
    x2, y2 = q_xy
    xp, yp = p_xy
    if x1 == x2 and y1 == y2:
        num = f12_mul(f12_sqr(x1), f12_from_fp(3))
        den = f12_mul(y1, f12_from_fp(2))
        lam = f12_mul(num, f12_inv(den))
    elif x1 == x2:
        # vertical line (t = -q): evaluates to xp - x1, sum is infinity
        return f12_sub(xp, x1), None
    else:
        lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_sqr(lam), x1), x2)
    y3 = f12_sub(f12_mul(lam, f12_sub(x1, x3)), y1)
    # l = (yp - y1) - lam*(xp - x1)
    l = f12_sub(f12_sub(yp, y1), f12_mul(lam, f12_sub(xp, x1)))
    return l, (x3, y3)


def miller_loop(p_pt: G1Point, q_pt: G2Point) -> Fp12:
    """f_{6x+2, Q}(P) with the two frobenius correction lines."""
    if p_pt is None or q_pt is None:
        return F12_ONE
    p_xy = (f12_from_fp(p_pt[0]), f12_from_fp(p_pt[1]))
    q12 = _psi(q_pt)
    f = F12_ONE
    t12 = q12
    for bit in bin(ATE_LOOP)[3:]:
        l, t12 = _line(t12, t12, p_xy)
        f = f12_mul(f12_sqr(f), l)
        if bit == "1":
            l, t12 = _line(t12, q12, p_xy)
            f = f12_mul(f, l)
    q1 = g2_frobenius(q_pt)
    q2 = g2_neg(g2_frobenius(q1))
    l, t12 = _line(t12, _psi(q1), p_xy)
    f = f12_mul(f, l)
    l, _ = _line(t12, _psi(q2), p_xy)
    f = f12_mul(f, l)
    return f


_FINAL_EXP = (P ** 12 - 1) // R


def final_exponentiation(f: Fp12) -> Fp12:
    return f12_pow(f, _FINAL_EXP)


def pairing(p_pt: G1Point, q_pt: G2Point) -> Fp12:
    return final_exponentiation(miller_loop(p_pt, q_pt))


# ----------------------------------------------------------------- EIP-197


def _read_g1(chunk: bytes) -> G1Point:
    x = int.from_bytes(chunk[0:32], "big")
    y = int.from_bytes(chunk[32:64], "big")
    if x >= P or y >= P:
        raise ValueError("G1 coordinate out of range")
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not g1_on_curve(pt):
        raise ValueError("G1 point not on curve")
    return pt


def _read_g2(chunk: bytes) -> G2Point:
    # EIP-197 packs Fp2 elements imaginary-part first
    xi_ = int.from_bytes(chunk[0:32], "big")
    xr = int.from_bytes(chunk[32:64], "big")
    yi = int.from_bytes(chunk[64:96], "big")
    yr = int.from_bytes(chunk[96:128], "big")
    if max(xi_, xr, yi, yr) >= P:
        raise ValueError("G2 coordinate out of range")
    if xi_ == 0 and xr == 0 and yi == 0 and yr == 0:
        return None
    pt = ((xr, xi_), (yr, yi))
    if not g2_on_curve(pt):
        raise ValueError("G2 point not on curve")
    if g2_mul(pt, R) is not None:
        raise ValueError("G2 point not in the r-torsion subgroup")
    return pt


def pairing_check(data: bytes) -> bool:
    """EIP-197: data is k*192 bytes of (G1, G2) pairs; true iff the product
    of pairings is the identity. Raises ValueError on malformed points."""
    if len(data) % 192:
        raise ValueError("input length must be a multiple of 192")
    f = F12_ONE
    for off in range(0, len(data), 192):
        p_pt = _read_g1(data[off : off + 64])
        q_pt = _read_g2(data[off + 64 : off + 192])
        if p_pt is None or q_pt is None:
            continue
        f = f12_mul(f, miller_loop(p_pt, q_pt))
    return final_exponentiation(f) == F12_ONE
