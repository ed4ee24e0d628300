"""Helper operations over BitVec/Bool wrappers, mirroring the reference's
mythril/laser/smt/bitvec_helper.py (annotation-union preserving wrappers)."""

from typing import List, Set, Union

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.bitvec import BitVec
from mythril_tpu_torch.smt.bool_ import Bool


def _comb_annotations(*exprs) -> Set:
    out: Set = set()
    for e in exprs:
        out = out.union(e.annotations)
    return out


def _coerce_bv(x: Union[int, BitVec], size: int = 256) -> BitVec:
    if isinstance(x, BitVec):
        return x
    return BitVec(terms.bv_const(int(x), size))


def If(a: Union[Bool, bool], b: Union[BitVec, int], c: Union[BitVec, int]) -> BitVec:
    """Ternary If expression; ints are coerced (to the width of the sibling
    branch, defaulting to 256)."""
    if not isinstance(a, Bool):
        a = Bool(terms.bool_const(bool(a)))
    size = b.size() if isinstance(b, BitVec) else (c.size() if isinstance(c, BitVec) else 256)
    b = _coerce_bv(b, size)
    c = _coerce_bv(c, size)
    return BitVec(terms.bv_ite(a.raw, b.raw, c.raw), _comb_annotations(a, b, c))


def UGT(a: BitVec, b: BitVec) -> Bool:
    return Bool(terms.bool_ult(b.raw, a.raw), _comb_annotations(a, b))


def UGE(a: BitVec, b: BitVec) -> Bool:
    return Bool(terms.bool_ule(b.raw, a.raw), _comb_annotations(a, b))


def ULT(a: BitVec, b: BitVec) -> Bool:
    return Bool(terms.bool_ult(a.raw, b.raw), _comb_annotations(a, b))


def ULE(a: BitVec, b: BitVec) -> Bool:
    return Bool(terms.bool_ule(a.raw, b.raw), _comb_annotations(a, b))


def UDiv(a: BitVec, b: BitVec) -> BitVec:
    return BitVec(terms.bv_udiv(a.raw, b.raw), _comb_annotations(a, b))


def URem(a: BitVec, b: BitVec) -> BitVec:
    return BitVec(terms.bv_urem(a.raw, b.raw), _comb_annotations(a, b))


def SRem(a: BitVec, b: BitVec) -> BitVec:
    return BitVec(terms.bv_srem(a.raw, b.raw), _comb_annotations(a, b))


def LShR(a: BitVec, b: BitVec) -> BitVec:
    return BitVec(terms.bv_lshr(a.raw, b.raw), _comb_annotations(a, b))


def Concat(*args: Union[BitVec, List[BitVec]]) -> BitVec:
    """Concat; first operand is most significant."""
    if len(args) == 1 and isinstance(args[0], list):
        bvs: List[BitVec] = args[0]
    else:
        bvs = list(args)  # type: ignore
    raw = terms.bv_concat([b.raw for b in bvs])
    return BitVec(raw, _comb_annotations(*bvs))


def Extract(high: int, low: int, bv: BitVec) -> BitVec:
    return BitVec(terms.bv_extract(high, low, bv.raw), set(bv.annotations))


def Sum(*args: BitVec) -> BitVec:
    if not args:
        raise ValueError("Sum of no terms")
    raw = args[0].raw
    for a in args[1:]:
        raw = terms.bv_add(raw, a.raw)
    return BitVec(raw, _comb_annotations(*args))


def BVAddNoOverflow(a: Union[BitVec, int], b: Union[BitVec, int], signed: bool) -> Bool:
    """True iff a + b does not overflow in `size` bits."""
    a = _coerce_bv(a)
    b = _coerce_bv(b)
    size = a.size()
    if signed:
        wa, wb = terms.bv_sext(1, a.raw), terms.bv_sext(1, b.raw)
        wide = terms.bv_add(wa, wb)
        fits = terms.bool_eq(wide, terms.bv_sext(1, terms.bv_extract(size - 1, 0, wide)))
    else:
        wa, wb = terms.bv_zext(1, a.raw), terms.bv_zext(1, b.raw)
        wide = terms.bv_add(wa, wb)
        fits = terms.bool_eq(terms.bv_extract(size, size, wide), terms.bv_const(0, 1))
    return Bool(fits, _comb_annotations(a, b))


def BVMulNoOverflow(a: Union[BitVec, int], b: Union[BitVec, int], signed: bool) -> Bool:
    """True iff a * b does not overflow in `size` bits."""
    a = _coerce_bv(a)
    b = _coerce_bv(b)
    size = a.size()
    if signed:
        wa, wb = terms.bv_sext(size, a.raw), terms.bv_sext(size, b.raw)
        wide = terms.bv_mul(wa, wb)
        fits = terms.bool_eq(wide, terms.bv_sext(size, terms.bv_extract(size - 1, 0, wide)))
    else:
        wa, wb = terms.bv_zext(size, a.raw), terms.bv_zext(size, b.raw)
        wide = terms.bv_mul(wa, wb)
        fits = terms.bool_eq(
            terms.bv_extract(2 * size - 1, size, wide), terms.bv_const(0, size)
        )
    return Bool(fits, _comb_annotations(a, b))


def BVSubNoUnderflow(a: Union[BitVec, int], b: Union[BitVec, int], signed: bool) -> Bool:
    """True iff a - b does not underflow."""
    a = _coerce_bv(a)
    b = _coerce_bv(b)
    size = a.size()
    if signed:
        wa, wb = terms.bv_sext(1, a.raw), terms.bv_sext(1, b.raw)
        wide = terms.bv_sub(wa, wb)
        fits = terms.bool_eq(wide, terms.bv_sext(1, terms.bv_extract(size - 1, 0, wide)))
        return Bool(fits, _comb_annotations(a, b))
    return Bool(terms.bool_ule(b.raw, a.raw), _comb_annotations(a, b))


def ZeroExt(extra: int, bv: BitVec) -> BitVec:
    return BitVec(terms.bv_zext(extra, bv.raw), set(bv.annotations))


def SignExt(extra: int, bv: BitVec) -> BitVec:
    return BitVec(terms.bv_sext(extra, bv.raw), set(bv.annotations))
