"""Unsigned value-interval analysis over the hash-consed Term DAG.

The third static-analysis stage's discharge oracle: a bottom-up
``[lo, hi]`` (inclusive, unsigned) bound per bitvector node, seeded
optionally with the taint-stage facts (``tables.cond_intervals``
maps a JUMPI site's condition word to the interval the dataflow proved
for EVERY execution reaching it; the bridge re-keys that by the lifted
condition term's uid). A boolean constraint whose operand intervals
decide it (``discharge``) is proven without bit-blasting at all.

Soundness shape (docs/REWRITE_PASS.md):

* structural bounds are universal — they hold for every assignment, so
  a ``discharge`` verdict derived from them alone is a theorem about
  the formula itself;
* seeded bounds are MUST facts about real executions (the taint stage
  only emits an interval when every path establishes it), so a seeded
  verdict is a theorem about *feasible* executions — exactly the
  question the round loop's feasibility filter asks. Seeded verdicts
  therefore share the scoping of the ``static_unsat`` seeds: they
  may be memoized per code hash + fact-schema version, never wider.

The transfer functions mirror ``analysis/static_pass/taint._interval``
but run over exact Term constants instead of abstract stack slots, so
they are strictly more precise (e.g. a concat of bounded slices keeps
a bound; a no-borrow SUB keeps both ends).
"""

from typing import Dict, Iterable, Optional, Tuple

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term, mask, post_order

Interval = Tuple[int, int]

# ops whose interval derives from the args below; everything else
# (vars, selects, applies, unmodeled ops) is the full range
_SIGNED_CMPS = ("slt", "sle")


def _full(size: int) -> Interval:
    return (0, mask(size))


def _join(a: Interval, b: Interval) -> Interval:
    return (min(a[0], b[0]), max(a[1], b[1]))


def _intersect(a: Interval, b: Interval) -> Optional[Interval]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo <= hi else None


def _transfer(t: Term, iv: Dict[int, Interval]) -> Interval:
    """Interval of one bv node from its args' intervals (all present)."""
    size = t.size
    op = t.op
    if op == "const":
        v = t.params[0]
        return (v, v)
    if op in ("var", "select", "apply", "neg", "sdiv", "srem"):
        return _full(size)
    if op in ("add", "sub", "mul", "udiv", "urem", "and", "or", "xor",
              "shl", "lshr", "ashr"):
        alo, ahi = iv[t.args[0].uid]
        blo, bhi = iv[t.args[1].uid]
        if op == "add" and ahi + bhi <= mask(size):
            return (alo + blo, ahi + bhi)
        if op == "sub" and alo >= bhi:
            return (alo - bhi, ahi - blo)
        if op == "mul" and ahi * bhi <= mask(size):
            return (alo * blo, ahi * bhi)
        if op == "udiv":
            # bvudiv x 0 = all-ones, so a divisor that may be zero
            # forfeits the upper bound entirely
            if blo >= 1:
                return (alo // bhi, ahi // blo)
            return _full(size)
        if op == "urem":
            # x urem y <= x always (x urem 0 = x); < y when y nonzero
            hi = min(ahi, bhi - 1) if blo >= 1 else ahi
            return (0, hi)
        if op == "and":
            return (0, min(ahi, bhi))
        if op == "or":
            bits = max(ahi.bit_length(), bhi.bit_length())
            hi = mask(size) if bits >= size else mask(bits)
            return (max(alo, blo), hi)
        if op == "xor":
            bits = max(ahi.bit_length(), bhi.bit_length())
            return (0, mask(size) if bits >= size else mask(bits))
        if op == "shl" and t.args[1].is_const:
            k = t.args[1].value
            if k < size and (ahi << k) <= mask(size):
                return (alo << k, ahi << k)
            return _full(size)
        if op == "lshr":
            if t.args[1].is_const:
                k = t.args[1].value
                return (0, 0) if k >= size else (alo >> k, ahi >> k)
            return (0, ahi)
        if op == "ashr":
            # only safe when the value is provably non-negative
            if ahi < (1 << (size - 1)):
                return (0, ahi)
            return _full(size)
        return _full(size)
    if op == "not":
        alo, ahi = iv[t.args[0].uid]
        return (mask(size) - ahi, mask(size) - alo)
    if op == "concat":
        lo = hi = 0
        for part in t.args:
            plo, phi = iv[part.uid]
            lo = (lo << part.size) + plo
            hi = (hi << part.size) + phi
        return (lo, hi)
    if op == "extract":
        ehi, elo = t.params
        alo, ahi = iv[t.args[0].uid]
        if elo == 0 and ahi <= mask(ehi + 1):
            return (alo, ahi)
        return _full(size)
    if op == "zext":
        return iv[t.args[0].uid]
    if op == "sext":
        src = t.args[0]
        alo, ahi = iv[src.uid]
        if ahi < (1 << (src.size - 1)):  # provably non-negative
            return (alo, ahi)
        return _full(size)
    if op == "ite":
        return _join(iv[t.args[1].uid], iv[t.args[2].uid])
    return _full(size)


def compute(
    roots: Iterable[Term],
    seeds: Optional[Dict[int, Interval]] = None,
) -> Dict[int, Interval]:
    """uid -> [lo, hi] for every BV node under ``roots`` (bool nodes are
    skipped; their children still get intervals). ``seeds`` narrows the
    seeded uid's structural bound by intersection; an empty intersection
    (a stale/foreign seed contradicting a constant) falls back to the
    structural bound rather than fabricating bottom."""
    iv: Dict[int, Interval] = {}
    for t in post_order(roots):
        if t.sort != "bv":
            continue
        bound = _transfer(t, iv)
        if seeds:
            seed = seeds.get(t.uid)
            if seed is not None:
                bound = _intersect(bound, (seed[0], seed[1])) or bound
        iv[t.uid] = bound
    return iv


def discharge(
    t: Term, iv: Dict[int, Interval], _memo: Optional[Dict[int, object]] = None
) -> Optional[bool]:
    """True / False when the intervals decide the boolean term ``t``;
    None when they do not. Pure interval reasoning: no blasting, no
    solving — every verdict is a consequence of the per-node bounds."""
    memo: Dict[int, object] = {} if _memo is None else _memo
    if t.uid in memo:
        return memo[t.uid]  # type: ignore[return-value]
    op = t.op
    out: Optional[bool] = None
    if op == "true":
        out = True
    elif op == "false":
        out = False
    elif op in ("eq", "ult", "ule") or op in _SIGNED_CMPS:
        a, b = t.args
        ia, ib = iv.get(a.uid), iv.get(b.uid)
        if ia is not None and ib is not None:
            alo, ahi = ia
            blo, bhi = ib
            if op in _SIGNED_CMPS:
                # signed compares reuse the unsigned ends only when both
                # sides are provably non-negative (sign bit clear)
                half = 1 << (a.size - 1)
                if ahi < half and bhi < half:
                    if op == "slt":
                        op = "ult"
                    else:
                        op = "ule"
            if op == "eq":
                if ahi < blo or bhi < alo:
                    out = False
                elif alo == ahi == blo == bhi:
                    out = True
            elif op == "ult":
                if ahi < blo:
                    out = True
                elif alo >= bhi:
                    out = False
            elif op == "ule":
                if ahi <= blo:
                    out = True
                elif alo > bhi:
                    out = False
    elif op == "bnot":
        sub = discharge(t.args[0], iv, memo)
        out = None if sub is None else (not sub)
    elif op == "band":
        vals = [discharge(a, iv, memo) for a in t.args]
        if any(v is False for v in vals):
            out = False
        elif all(v is True for v in vals):
            out = True
    elif op == "bor":
        vals = [discharge(a, iv, memo) for a in t.args]
        if any(v is True for v in vals):
            out = True
        elif all(v is False for v in vals):
            out = False
    elif op == "iff":
        va = discharge(t.args[0], iv, memo)
        vb = discharge(t.args[1], iv, memo)
        if va is not None and vb is not None:
            out = va == vb
    memo[t.uid] = out
    return out


def discharge_set(
    raw_terms: Iterable[Term],
    seeds: Optional[Dict[int, Interval]] = None,
) -> Dict[int, Optional[bool]]:
    """One shared interval pass over a constraint set: uid -> verdict
    (None = undecided) for each distinct root."""
    roots = [t for t in raw_terms if t.sort == terms.BOOL]
    iv = compute(roots, seeds)
    memo: Dict[int, object] = {}
    return {t.uid: discharge(t, iv, memo) for t in roots}
