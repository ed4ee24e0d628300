"""Word-level rewrite rules over the constraint IR (docs/REWRITE_PASS.md).

Every rule is a pure function ``Term -> Optional[Term]`` registered
through the ``@rule`` decorator: it inspects ONE node (whose children
the engine has already rewritten) and returns an equivalent replacement
or None. Equivalence is per-term and assignment-wise — for every
assignment of the free symbols, the original and the replacement
evaluate identically (``terms.evaluate`` is the oracle the property
tests use) — so any conjunction containing a rewritten member is
equisatisfiable with the original by congruence.

Registration contract (enforced by scripts/lint.py ``rewrite_soundness``):
every rule MUST carry ``sound_for=`` (the equivalence class of the rule:
"equivalence" is the only admissible value today — rules that merely
preserve satisfiability one-way would poison the shared memo) and
``prop_test=`` naming the test function in
tests/laser/test_rewrite_pass.py that exercises it against the
evaluate oracle. An unannotated registration is a lint failure.

Rules keep the result built through the smart constructors in
smt/terms.py, so constant folding and hash-consing apply to every
replacement and the engine's structural-equality fixpoint check stays
exact.
"""

from typing import Callable, Dict, List, Optional

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term, mask

RuleFn = Callable[[Term], Optional[Term]]


class RewriteRule:
    """A registered rule with its soundness annotation."""

    __slots__ = ("fn", "name", "sound_for", "prop_test")

    def __init__(self, fn: RuleFn, name: str, sound_for: str, prop_test: str):
        self.fn = fn
        self.name = name
        self.sound_for = sound_for
        self.prop_test = prop_test

    def __call__(self, t: Term) -> Optional[Term]:
        return self.fn(t)


RULES: List[RewriteRule] = []
# op -> rules that can fire on it (dispatch; a rule names its trigger
# ops so the engine skips non-matching nodes without a call)
_BY_OP: Dict[str, List[RewriteRule]] = {}


def rule(*, sound_for: str, prop_test: str, ops: tuple):
    """Register a rewrite rule. ``sound_for`` must be "equivalence"
    (assignment-wise equality of original and replacement); ``prop_test``
    names the property test that checks the rule against the
    ``terms.evaluate`` oracle; ``ops`` lists the node ops the rule can
    fire on (dispatch only — firing on a superset is sound, just slow).
    """
    if sound_for != "equivalence":
        raise ValueError(
            "rewrite rules must be annotated sound_for='equivalence'; "
            "got %r" % (sound_for,)
        )

    def register(fn: RuleFn) -> RewriteRule:
        rr = RewriteRule(fn, fn.__name__, sound_for, prop_test)
        RULES.append(rr)
        for op in ops:
            _BY_OP.setdefault(op, []).append(rr)
        return rr

    return register


def rules_for(op: str) -> List[RewriteRule]:
    return _BY_OP.get(op, ())  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# comparison rules
# ---------------------------------------------------------------------------


@rule(
    sound_for="equivalence",
    prop_test="test_rule_not_cmp",
    ops=("bnot",),
)
def not_cmp(t: Term) -> Optional[Term]:
    """not(a <u b) = b <=u a, and the three mirrored forms. Negated
    comparisons lower to an extra CNF equivalence per bit; the flipped
    positive form does not, and canonicalizing the polarity merges
    alpha keys of e.g. ``Not(ULT(x, k))`` and ``UGE(x, k)`` lanes."""
    a = t.args[0]
    if a.op == "ult":
        return terms.bool_ule(a.args[1], a.args[0])
    if a.op == "ule":
        return terms.bool_ult(a.args[1], a.args[0])
    if a.op == "slt":
        return terms.bool_sle(a.args[1], a.args[0])
    if a.op == "sle":
        return terms.bool_slt(a.args[1], a.args[0])
    return None


@rule(
    sound_for="equivalence",
    prop_test="test_rule_cmp_bounds",
    ops=("ult", "ule"),
)
def cmp_bounds(t: Term) -> Optional[Term]:
    """Compares against the domain's extreme constants: nothing is below
    zero or above all-ones, ``x < 1`` is ``x = 0``, ``x <= 0`` is
    ``x = 0``, and ``0 < x`` is ``not (x = 0)`` — the JUMPI condition
    shape the EVM emits for every require()."""
    a, b = t.args
    size = a.size
    zero = terms.bv_const(0, size)
    if t.op == "ult":
        if b.is_const:
            if b.value == 0:
                return terms.FALSE
            if b.value == 1:
                return terms.bool_eq(a, zero)
        if a.is_const:
            if a.value == mask(size):
                return terms.FALSE
            if a.value == 0:
                return terms.bool_not(terms.bool_eq(b, zero))
    else:  # ule
        if b.is_const:
            if b.value == mask(size):
                return terms.TRUE
            if b.value == 0:
                return terms.bool_eq(a, zero)
        if a.is_const and a.value == 0:
            return terms.TRUE
    return None


@rule(
    sound_for="equivalence",
    prop_test="test_rule_eq_shift",
    ops=("eq",),
)
def eq_shift(t: Term) -> Optional[Term]:
    """Move invertible arithmetic across an equality with a constant:
    ``x + c1 = c2`` is ``x = c2 - c1``; ``a - b = 0`` and
    ``a xor b = 0`` are ``a = b``; ``not x = c`` is ``x = not c``. The
    solver sees one comparison against a literal instead of an adder."""
    a, b = t.args
    # bool_eq orders args by uid, so the constant can land on either side
    if a.is_const and not b.is_const:
        a, b = b, a
    if b.is_const:
        if a.op == "add" and a.args[1].is_const:
            c = (b.value - a.args[1].value) & mask(a.size)
            return terms.bool_eq(a.args[0], terms.bv_const(c, a.size))
        if a.op == "not":
            return terms.bool_eq(
                a.args[0], terms.bv_const(~b.value & mask(a.size), a.size)
            )
        if b.value == 0:
            if a.op == "sub":
                return terms.bool_eq(a.args[0], a.args[1])
            if a.op == "xor":
                return terms.bool_eq(a.args[0], a.args[1])
            if a.op == "neg":
                return terms.bool_eq(
                    a.args[0], terms.bv_const(0, a.size)
                )
    return None


@rule(
    sound_for="equivalence",
    prop_test="test_rule_ite_lift",
    ops=("eq", "ult", "ule", "slt", "sle"),
)
def ite_lift(t: Term) -> Optional[Term]:
    """Lift a comparison over an ite with constant arms into the boolean
    domain: ``cmp(ite(c, k1, k2), k)`` folds each arm against ``k`` and
    becomes ``c``, ``not c``, TRUE, FALSE, or an or-of-ands — the
    Solidity bool-storage pattern (``ite(c, 1, 0) = 1``) collapses to
    just ``c`` and never reaches the blaster."""
    a, b = t.args
    ite_side, const_side, swapped = a, b, False
    if ite_side.op != "ite":
        ite_side, const_side, swapped = b, a, True
    if ite_side.op != "ite" or not const_side.is_const:
        return None
    cond, arm1, arm2 = ite_side.args
    if not (arm1.is_const and arm2.is_const):
        return None

    def fold(arm: Term) -> Term:
        x, y = (const_side, arm) if swapped else (arm, const_side)
        if t.op == "eq":
            return terms.bool_const(x.value == y.value)
        fn = terms._CMP_FOLDS[t.op]
        return terms.bool_const(fn(x.value, y.value, x.size))

    v1, v2 = fold(arm1), fold(arm2)
    return terms.bool_or(
        terms.bool_and(cond, v1),
        terms.bool_and(terms.bool_not(cond), v2),
    )


# ---------------------------------------------------------------------------
# boolean-structure rules
# ---------------------------------------------------------------------------

# the negation of each comparison with its args swapped: not(a<b) = b<=a
_CMP_FLIP = {"ult": "ule", "ule": "ult", "slt": "sle", "sle": "slt"}


@rule(
    sound_for="equivalence",
    prop_test="test_rule_bool_complement",
    ops=("band", "bor"),
)
def bool_complement(t: Term) -> Optional[Term]:
    """``and(..., x, not x, ...)`` is FALSE; ``or(..., x, not x, ...)``
    is TRUE. The constructors already flatten and dedupe, so one linear
    scan over the (flat) argument list finds any complementary pair.
    Because ``not_cmp`` canonicalizes comparison polarity BEFORE the
    parent connective is rebuilt, a comparison's complement is its
    flipped-and-swapped form (``not(a <u b)`` IS ``b <=u a``), never a
    surviving bnot — so the scan matches those shapes directly."""
    have = {a.uid for a in t.args}
    sigs = {
        (a.op, a.args[0].uid, a.args[1].uid)
        for a in t.args
        if a.op in _CMP_FLIP
    }
    for a in t.args:
        if a.op == "bnot" and a.args[0].uid in have:
            return terms.FALSE if t.op == "band" else terms.TRUE
        if a.op in _CMP_FLIP and (
            _CMP_FLIP[a.op],
            a.args[1].uid,
            a.args[0].uid,
        ) in sigs:
            return terms.FALSE if t.op == "band" else terms.TRUE
    return None


# ---------------------------------------------------------------------------
# slice-normalization rules (Extract/Concat)
# ---------------------------------------------------------------------------


@rule(
    sound_for="equivalence",
    prop_test="test_rule_slice_eq_split",
    ops=("eq",),
)
def slice_eq_split(t: Term) -> Optional[Term]:
    """Split a word equality along its concatenation seams:
    ``concat(a, b) = c`` becomes ``a = c_hi and b = c_lo``, and
    ``zext(x) = c`` becomes ``x = c`` (or FALSE when ``c`` overflows the
    source width). EVM calldata decoding compares 256-bit words whose
    upper lanes are zero-extensions; splitting lets the blaster see the
    narrow compare and drops the wide adder/equality chains."""
    a, b = t.args
    if a.is_const and not b.is_const:
        a, b = b, a
    if not b.is_const:
        return None
    if a.op == "concat":
        conjuncts = []
        pos = a.size
        for part in a.args:
            pos -= part.size
            pv = (b.value >> pos) & mask(part.size)
            conjuncts.append(
                terms.bool_eq(part, terms.bv_const(pv, part.size))
            )
        return terms.bool_and(*conjuncts)
    if a.op == "zext":
        src = a.args[0]
        if b.value > mask(src.size):
            return terms.FALSE
        return terms.bool_eq(src, terms.bv_const(b.value, src.size))
    return None


# ---------------------------------------------------------------------------
# arithmetic strength reduction
# ---------------------------------------------------------------------------


def _pow2(v: int) -> Optional[int]:
    if v > 0 and (v & (v - 1)) == 0:
        return v.bit_length() - 1
    return None


@rule(
    sound_for="equivalence",
    prop_test="test_rule_pow2_strength",
    ops=("mul", "udiv", "urem"),
)
def pow2_strength(t: Term) -> Optional[Term]:
    """Multiplication, division, and remainder by a power-of-two
    constant become shifts and slices: ``x * 2^k = x << k``,
    ``x / 2^k = x >> k``, ``x % 2^k = zext(x[k-1:0])``. A 256-bit
    multiplier blasts to tens of thousands of clauses; a constant shift
    blasts to zero (pure wiring)."""
    a, b = t.args
    if t.op == "mul" and a.is_const and not b.is_const:
        a, b = b, a
    if not b.is_const:
        return None
    k = _pow2(b.value)
    if k is None:
        return None
    sh = terms.bv_const(k, a.size)
    if t.op == "mul":
        return terms.bv_shl(a, sh)
    if t.op == "udiv":
        return terms.bv_lshr(a, sh)
    # urem
    if k == 0:
        return terms.bv_const(0, a.size)
    return terms.bv_zext(a.size - k, terms.bv_extract(k - 1, 0, a))
