"""Hash-consed bitvector/boolean/array term DAG — the core IR of the SMT layer.

This replaces the z3 AST used by the reference (mythril/laser/smt/*, which wraps
z3.ExprRef). Terms are immutable, hash-consed (structural equality == identity)
and carry dense integer uids so that term graphs can later be lowered to flat
tensor "tapes" and shipped to TPU for batched evaluation / local-search solving.

Design notes:
- Sorts: 'bv' (sized), 'bool', 'array' (bv->bv), plus uninterpreted-function
  applications ('apply').
- Smart constructors perform constant folding and light algebraic rewrites so
  that fully-concrete EVM execution never leaves the "const" fast path.
- Semantics of the folds follow SMT-LIB QF_BV (bvudiv x 0 = all-ones, etc.);
  EVM-level special cases (DIV by zero = 0, ...) are expressed with explicit
  guards by the interpreter layer, matching how the reference builds the same
  expressions over z3.
"""

from typing import Dict, Iterable, Optional, Tuple, Union
import itertools
import threading
import weakref

_uid_counter = itertools.count()
_intern: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_intern_lock = threading.Lock()

BV = "bv"
BOOL = "bool"
ARRAY = "array"

# ---------------------------------------------------------------------------
# Term


class Term:
    """A hash-consed node of the expression DAG."""

    __slots__ = ("uid", "op", "sort", "size", "args", "params", "__weakref__")

    def __init__(self, op: str, sort: str, size: int, args: Tuple["Term", ...], params: Tuple):
        self.uid = next(_uid_counter)
        self.op = op
        self.sort = sort
        self.size = size  # bit width for bv; 1 for bool; value width for arrays
        self.args = args
        self.params = params

    # Identity-based hashing: hash-consing guarantees structural equality
    # implies identity, so the default object hash/eq are correct and fast.

    def __reduce__(self):
        # pickling rebuilds through _mk so loaded terms re-intern into the
        # live hash-cons table (open-state checkpointing, SURVEY §5)
        return (_mk, (self.op, self.sort, self.size, self.args, self.params))

    @property
    def is_const(self) -> bool:
        return self.op == "const" or self.op in ("true", "false")

    @property
    def value(self) -> Optional[int]:
        if self.op == "const":
            return self.params[0]
        if self.op == "true":
            return 1
        if self.op == "false":
            return 0
        return None

    @property
    def name(self) -> Optional[str]:
        if self.op in ("var", "boolvar", "array_var"):
            return self.params[0]
        return None

    def __repr__(self) -> str:
        return to_sexpr(self, max_depth=6)


def _mk(op: str, sort: str, size: int, args: Tuple[Term, ...] = (), params: Tuple = ()) -> Term:
    key = (op, sort, size, tuple(a.uid for a in args), params)
    with _intern_lock:
        t = _intern.get(key)
        if t is None:
            t = Term(op, sort, size, args, params)
            _intern[key] = t
        return t


def term_cache_size() -> int:
    return len(_intern)


# ---------------------------------------------------------------------------
# Integer helpers


def mask(size: int) -> int:
    return (1 << size) - 1


def to_signed(value: int, size: int) -> int:
    value &= mask(size)
    if value >= 1 << (size - 1):
        return value - (1 << size)
    return value


def from_signed(value: int, size: int) -> int:
    return value & mask(size)


# ---------------------------------------------------------------------------
# Leaf constructors


def bv_const(value: int, size: int) -> Term:
    return _mk("const", BV, size, params=(value & mask(size),))


def bv_var(name: str, size: int) -> Term:
    return _mk("var", BV, size, params=(name,))


TRUE = _mk("true", BOOL, 1)
FALSE = _mk("false", BOOL, 1)


def bool_const(value: bool) -> Term:
    return TRUE if value else FALSE


def bool_var(name: str) -> Term:
    return _mk("boolvar", BOOL, 1, params=(name,))


def array_var(name: str, domain: int, value_range: int) -> Term:
    return _mk("array_var", ARRAY, value_range, params=(name, domain, value_range))


def const_array(domain: int, value_range: int, value: int) -> Term:
    return _mk("const_array", ARRAY, value_range, params=(domain, value_range, value & mask(value_range)))


# ---------------------------------------------------------------------------
# Bitvector operations (smart constructors with folding)


def _require_bv(*terms: Term) -> None:
    for t in terms:
        if t.sort != BV:
            raise TypeError("expected bitvector term, got %s (%s)" % (t.sort, t.op))


def _same_size(a: Term, b: Term) -> None:
    if a.size != b.size:
        raise ValueError("bitvector size mismatch: %d vs %d" % (a.size, b.size))


def _binop(op: str, a: Term, b: Term, fold) -> Term:
    _require_bv(a, b)
    _same_size(a, b)
    if a.is_const and b.is_const:
        return bv_const(fold(a.value, b.value, a.size), a.size)
    return _mk(op, BV, a.size, (a, b))


def bv_add(a: Term, b: Term) -> Term:
    # canonicalize constants to the right so chains can reassociate
    if a.is_const and not b.is_const:
        a, b = b, a
    if b.is_const:
        if b.value == 0:
            return a
        # (x + c1) + c2 -> x + (c1 + c2): incremental index arithmetic
        # (calldata/memory walks) must converge to one canonical node or
        # structural-equality loop exits never fire
        if a.op == "add" and a.args[1].is_const:
            return bv_add(
                a.args[0], bv_const((a.args[1].value + b.value) & mask(a.size), a.size)
            )
    return _binop("add", a, b, lambda x, y, s: x + y)


def bv_sub(a: Term, b: Term) -> Term:
    if b.is_const and b.value == 0:
        return a
    if a is b:
        return bv_const(0, a.size)
    return _binop("sub", a, b, lambda x, y, s: x - y)


def bv_mul(a: Term, b: Term) -> Term:
    for x, y in ((a, b), (b, a)):
        if x.is_const:
            if x.value == 0:
                return bv_const(0, a.size)
            if x.value == 1:
                return y
    return _binop("mul", a, b, lambda x, y, s: x * y)


def _fold_udiv(x: int, y: int, s: int) -> int:
    return mask(s) if y == 0 else x // y


def _fold_sdiv(x: int, y: int, s: int) -> int:
    sx, sy = to_signed(x, s), to_signed(y, s)
    if sy == 0:
        return 1 if sx < 0 else mask(s)  # SMT-LIB bvsdiv by zero
    q = abs(sx) // abs(sy)
    if (sx < 0) != (sy < 0):
        q = -q
    return from_signed(q, s)


def _fold_urem(x: int, y: int, s: int) -> int:
    return x if y == 0 else x % y


def _fold_srem(x: int, y: int, s: int) -> int:
    sx, sy = to_signed(x, s), to_signed(y, s)
    if sy == 0:
        return x
    r = abs(sx) % abs(sy)
    if sx < 0:
        r = -r
    return from_signed(r, s)


def bv_udiv(a: Term, b: Term) -> Term:
    if b.is_const and b.value == 1:
        return a
    return _binop("udiv", a, b, _fold_udiv)


def bv_sdiv(a: Term, b: Term) -> Term:
    if b.is_const and b.value == 1:
        return a
    return _binop("sdiv", a, b, _fold_sdiv)


def bv_urem(a: Term, b: Term) -> Term:
    return _binop("urem", a, b, _fold_urem)


def bv_srem(a: Term, b: Term) -> Term:
    return _binop("srem", a, b, _fold_srem)


def bv_and(a: Term, b: Term) -> Term:
    for x, y in ((a, b), (b, a)):
        if x.is_const:
            if x.value == 0:
                return bv_const(0, a.size)
            if x.value == mask(a.size):
                return y
    if a is b:
        return a
    return _binop("and", a, b, lambda x, y, s: x & y)


def bv_or(a: Term, b: Term) -> Term:
    for x, y in ((a, b), (b, a)):
        if x.is_const:
            if x.value == 0:
                return y
            if x.value == mask(a.size):
                return bv_const(mask(a.size), a.size)
    if a is b:
        return a
    return _binop("or", a, b, lambda x, y, s: x | y)


def bv_xor(a: Term, b: Term) -> Term:
    if a is b:
        return bv_const(0, a.size)
    for x, y in ((a, b), (b, a)):
        if x.is_const and x.value == 0:
            return y
    return _binop("xor", a, b, lambda x, y, s: x ^ y)


def bv_not(a: Term) -> Term:
    _require_bv(a)
    if a.is_const:
        return bv_const(~a.value, a.size)
    if a.op == "not":
        return a.args[0]
    return _mk("not", BV, a.size, (a,))


def bv_neg(a: Term) -> Term:
    _require_bv(a)
    if a.is_const:
        return bv_const(-a.value, a.size)
    return _mk("neg", BV, a.size, (a,))


def _fold_shl(x: int, y: int, s: int) -> int:
    return 0 if y >= s else ((x << y) & mask(s))


def _fold_lshr(x: int, y: int, s: int) -> int:
    return 0 if y >= s else (x >> y)


def _fold_ashr(x: int, y: int, s: int) -> int:
    sx = to_signed(x, s)
    if y >= s:
        return mask(s) if sx < 0 else 0
    return from_signed(sx >> y, s)


def bv_shl(a: Term, b: Term) -> Term:
    if b.is_const and b.value == 0:
        return a
    return _binop("shl", a, b, _fold_shl)


def bv_lshr(a: Term, b: Term) -> Term:
    if b.is_const and b.value == 0:
        return a
    return _binop("lshr", a, b, _fold_lshr)


def bv_ashr(a: Term, b: Term) -> Term:
    if b.is_const and b.value == 0:
        return a
    return _binop("ashr", a, b, _fold_ashr)


def bv_concat(args: Iterable[Term]) -> Term:
    """Concat, first argument is most significant (z3 convention)."""
    arglist = []
    for a in args:  # flatten nested concats
        _require_bv(a)
        if a.op == "concat":
            arglist.extend(a.args)
        else:
            arglist.append(a)
    if not arglist:
        raise ValueError("concat of zero terms")
    # merge adjacent constants and adjacent extracts of the same base term
    merged = [arglist[0]]
    for a in arglist[1:]:
        prev = merged[-1]
        if a.is_const and prev.is_const:
            merged[-1] = bv_const((prev.value << a.size) | a.value, prev.size + a.size)
        elif (
            a.op == "extract"
            and prev.op == "extract"
            and a.args[0] is prev.args[0]
            and prev.params[1] == a.params[0] + 1
        ):
            merged[-1] = bv_extract(prev.params[0], a.params[1], a.args[0])
        else:
            merged.append(a)
    if len(merged) == 1:
        return merged[0]
    total = sum(a.size for a in merged)
    return _mk("concat", BV, total, tuple(merged))


def bv_extract(hi: int, lo: int, a: Term) -> Term:
    _require_bv(a)
    if not (0 <= lo <= hi < a.size):
        raise ValueError("bad extract bounds [%d:%d] of %d-bit term" % (hi, lo, a.size))
    width = hi - lo + 1
    if width == a.size:
        return a
    if a.is_const:
        return bv_const(a.value >> lo, width)
    if a.op == "concat":
        # resolve extract into the concat parts when it aligns
        pos = a.size
        for part in a.args:
            pos -= part.size
            if lo >= pos and hi < pos + part.size:
                return bv_extract(hi - pos, lo - pos, part)
    if a.op == "extract":
        inner_lo = a.params[1]
        return bv_extract(hi + inner_lo, lo + inner_lo, a.args[0])
    if a.op in ("zext", "sext"):
        src = a.args[0]
        if hi < src.size:
            return bv_extract(hi, lo, src)
    return _mk("extract", BV, width, (a,), (hi, lo))


def bv_zext(extra: int, a: Term) -> Term:
    _require_bv(a)
    if extra == 0:
        return a
    if a.is_const:
        return bv_const(a.value, a.size + extra)
    return _mk("zext", BV, a.size + extra, (a,), (extra,))


def bv_sext(extra: int, a: Term) -> Term:
    _require_bv(a)
    if extra == 0:
        return a
    if a.is_const:
        return bv_const(from_signed(to_signed(a.value, a.size), a.size + extra), a.size + extra)
    return _mk("sext", BV, a.size + extra, (a,), (extra,))


def bv_ite(cond: Term, a: Term, b: Term) -> Term:
    if cond.sort != BOOL:
        raise TypeError("ite condition must be bool")
    _require_bv(a, b)
    _same_size(a, b)
    if cond is TRUE:
        return a
    if cond is FALSE:
        return b
    if a is b:
        return a
    return _mk("ite", BV, a.size, (cond, a, b))


# ---------------------------------------------------------------------------
# Boolean operations


def _pad_pair(a: Term, b: Term) -> Tuple[Term, Term]:
    """Zero-pad the smaller operand (the reference does this for 512-bit sha3
    operands, mythril/laser/smt/bitvec.py:16)."""
    if a.size == b.size:
        return a, b
    if a.size < b.size:
        a = bv_zext(b.size - a.size, a)
    else:
        b = bv_zext(a.size - b.size, b)
    return a, b


def bool_eq(a: Term, b: Term) -> Term:
    if a.sort == BOOL and b.sort == BOOL:
        return bool_iff(a, b)
    _require_bv(a, b)
    a, b = _pad_pair(a, b)
    if a is b:
        return TRUE
    if a.is_const and b.is_const:
        return bool_const(a.value == b.value)
    if a.uid > b.uid:  # canonical order for better sharing
        a, b = b, a
    return _mk("eq", BOOL, 1, (a, b))


def bool_ne(a: Term, b: Term) -> Term:
    return bool_not(bool_eq(a, b))


def _cmp(op: str, a: Term, b: Term, fold) -> Term:
    _require_bv(a, b)
    a, b = _pad_pair(a, b)
    if a.is_const and b.is_const:
        return bool_const(fold(a.value, b.value, a.size))
    if a is b:
        return bool_const(fold(0, 0, 1))
    return _mk(op, BOOL, 1, (a, b))


def bool_ult(a: Term, b: Term) -> Term:
    return _cmp("ult", a, b, lambda x, y, s: x < y)


def bool_ule(a: Term, b: Term) -> Term:
    return _cmp("ule", a, b, lambda x, y, s: x <= y)


def bool_slt(a: Term, b: Term) -> Term:
    return _cmp("slt", a, b, lambda x, y, s: to_signed(x, s) < to_signed(y, s))


def bool_sle(a: Term, b: Term) -> Term:
    return _cmp("sle", a, b, lambda x, y, s: to_signed(x, s) <= to_signed(y, s))


def bool_not(a: Term) -> Term:
    if a.sort != BOOL:
        raise TypeError("not expects bool")
    if a is TRUE:
        return FALSE
    if a is FALSE:
        return TRUE
    if a.op == "bnot":
        return a.args[0]
    return _mk("bnot", BOOL, 1, (a,))


def bool_and(*args: Term) -> Term:
    flat = []
    for a in args:
        if a.sort != BOOL:
            raise TypeError("and expects bools")
        if a is FALSE:
            return FALSE
        if a is TRUE:
            continue
        if a.op == "band":
            flat.extend(a.args)
        else:
            flat.append(a)
    # dedupe, keep deterministic order
    seen: Dict[int, Term] = {}
    for a in flat:
        seen.setdefault(a.uid, a)
    flat = list(seen.values())
    if not flat:
        return TRUE
    if len(flat) == 1:
        return flat[0]
    return _mk("band", BOOL, 1, tuple(flat))


def bool_or(*args: Term) -> Term:
    flat = []
    for a in args:
        if a.sort != BOOL:
            raise TypeError("or expects bools")
        if a is TRUE:
            return TRUE
        if a is FALSE:
            continue
        if a.op == "bor":
            flat.extend(a.args)
        else:
            flat.append(a)
    seen: Dict[int, Term] = {}
    for a in flat:
        seen.setdefault(a.uid, a)
    flat = list(seen.values())
    if not flat:
        return FALSE
    if len(flat) == 1:
        return flat[0]
    return _mk("bor", BOOL, 1, tuple(flat))


def bool_iff(a: Term, b: Term) -> Term:
    if a is b:
        return TRUE
    if a is TRUE:
        return b
    if b is TRUE:
        return a
    if a is FALSE:
        return bool_not(b)
    if b is FALSE:
        return bool_not(a)
    if a.uid > b.uid:
        a, b = b, a
    return _mk("iff", BOOL, 1, (a, b))


def bool_ite(cond: Term, a: Term, b: Term) -> Term:
    if cond is TRUE:
        return a
    if cond is FALSE:
        return b
    if a is b:
        return a
    return bool_or(bool_and(cond, a), bool_and(bool_not(cond), b))


# ---------------------------------------------------------------------------
# Arrays & uninterpreted functions


def array_store(arr: Term, idx: Term, val: Term) -> Term:
    if arr.sort != ARRAY:
        raise TypeError("store expects array")
    dom = array_domain(arr)
    if idx.size != dom:
        raise ValueError("store index size %d != domain %d" % (idx.size, dom))
    if val.size != arr.size:
        raise ValueError("store value size %d != range %d" % (val.size, arr.size))
    return _mk("store", ARRAY, arr.size, (arr, idx, val))


def array_domain(arr: Term) -> int:
    node = arr
    while node.op == "store":
        node = node.args[0]
    if node.op == "array_var":
        return node.params[1]
    if node.op == "const_array":
        return node.params[0]
    raise TypeError("not an array: %s" % node.op)


def array_select(arr: Term, idx: Term) -> Term:
    if arr.sort != ARRAY:
        raise TypeError("select expects array")
    # Walk the store chain: resolves concrete reads of concrete writes without
    # touching the solver (calldata/storage fast path).
    node = arr
    while node.op == "store":
        sidx = node.args[1]
        if sidx is idx:
            return node.args[2]
        if sidx.is_const and idx.is_const:
            if sidx.value == idx.value:
                return node.args[2]
            node = node.args[0]
            continue
        break  # ambiguous (symbolic index in chain); leave symbolic
    if node.op == "const_array":
        # Reached the bottom with no possible aliasing (the walk only descends
        # through provably-not-matching stores), so the default applies — this
        # also covers select(K(c), symbolic_idx) == c with no stores at all.
        return bv_const(node.params[2], node.size)
    return _mk("select", BV, arr.size, (arr, idx))


def func_app(name: str, args: Tuple[Term, ...], domain: Tuple[int, ...], range_size: int) -> Term:
    if len(args) != len(domain):
        raise ValueError("arity mismatch for %s" % name)
    for a, d in zip(args, domain):
        if a.size != d:
            raise ValueError("argument size mismatch for %s" % name)
    return _mk("apply", BV, range_size, tuple(args), (name, domain, range_size))


# ---------------------------------------------------------------------------
# Concrete evaluation (the semantics oracle; also used by Model.eval)


class EvalEnv:
    """Assignment of free symbols for concrete evaluation.

    bv_values: name -> int, bool_values: name -> bool,
    arrays: name -> (dict idx->val, default int),
    funcs: name -> dict args-tuple -> int (missing entries -> 0).
    """

    __slots__ = ("bv_values", "bool_values", "arrays", "funcs", "completion")

    def __init__(self, bv_values=None, bool_values=None, arrays=None, funcs=None, completion=True):
        self.bv_values = bv_values or {}
        self.bool_values = bool_values or {}
        self.arrays = arrays or {}
        self.funcs = funcs or {}
        self.completion = completion


class IncompleteModelError(KeyError):
    pass


_BIN_FOLDS = {
    "add": lambda x, y, s: (x + y) & mask(s),
    "sub": lambda x, y, s: (x - y) & mask(s),
    "mul": lambda x, y, s: (x * y) & mask(s),
    "udiv": _fold_udiv,
    "sdiv": _fold_sdiv,
    "urem": _fold_urem,
    "srem": _fold_srem,
    "and": lambda x, y, s: x & y,
    "or": lambda x, y, s: x | y,
    "xor": lambda x, y, s: x ^ y,
    "shl": _fold_shl,
    "lshr": _fold_lshr,
    "ashr": _fold_ashr,
}

_CMP_FOLDS = {
    "ult": lambda x, y, s: x < y,
    "ule": lambda x, y, s: x <= y,
    "slt": lambda x, y, s: to_signed(x, s) < to_signed(y, s),
    "sle": lambda x, y, s: to_signed(x, s) <= to_signed(y, s),
}


def evaluate(term: Term, env: EvalEnv, _memo: Optional[Dict[int, Union[int, bool, tuple]]] = None):
    """Evaluate a term to a python int (bv) / bool under the given assignment."""
    memo: Dict[int, Union[int, bool, tuple]] = {} if _memo is None else _memo

    def arr_lookup(arr: Term, idx: int) -> int:
        node = arr
        while node.op == "store":
            if rec(node.args[1]) == idx:
                return rec(node.args[2])
            node = node.args[0]
        if node.op == "const_array":
            return node.params[2]
        store, default = env.arrays.get(node.params[0], ({}, 0))
        if idx in store:
            return store[idx]
        if not env.completion and node.params[0] not in env.arrays:
            raise IncompleteModelError(node.params[0])
        return default

    def rec(t: Term):
        r = memo.get(t.uid)
        if r is not None:
            return r
        op = t.op
        if op == "const":
            v = t.params[0]
        elif op == "true":
            v = True
        elif op == "false":
            v = False
        elif op == "var":
            # sized key first: same-named vars of different widths are
            # distinct symbols (the solver's model writes both keys)
            sized = (t.params[0], t.size)
            if sized in env.bv_values:
                v = env.bv_values[sized] & mask(t.size)
            elif t.params[0] in env.bv_values:
                v = env.bv_values[t.params[0]] & mask(t.size)
            elif env.completion:
                v = 0
            else:
                raise IncompleteModelError(t.params[0])
        elif op == "boolvar":
            if t.params[0] in env.bool_values:
                v = bool(env.bool_values[t.params[0]])
            elif env.completion:
                v = False
            else:
                raise IncompleteModelError(t.params[0])
        elif op in _BIN_FOLDS:
            v = _BIN_FOLDS[op](rec(t.args[0]), rec(t.args[1]), t.size)
        elif op in _CMP_FOLDS:
            v = _CMP_FOLDS[op](rec(t.args[0]), rec(t.args[1]), t.args[0].size)
        elif op == "not":
            v = (~rec(t.args[0])) & mask(t.size)
        elif op == "neg":
            v = (-rec(t.args[0])) & mask(t.size)
        elif op == "concat":
            v = 0
            for part in t.args:
                v = (v << part.size) | rec(part)
        elif op == "extract":
            hi, lo = t.params
            v = (rec(t.args[0]) >> lo) & mask(hi - lo + 1)
        elif op == "zext":
            v = rec(t.args[0])
        elif op == "sext":
            src = t.args[0]
            v = from_signed(to_signed(rec(src), src.size), t.size)
        elif op == "ite":
            v = rec(t.args[1]) if rec(t.args[0]) else rec(t.args[2])
        elif op == "eq":
            v = rec(t.args[0]) == rec(t.args[1])
        elif op == "bnot":
            v = not rec(t.args[0])
        elif op == "band":
            v = all(rec(a) for a in t.args)
        elif op == "bor":
            v = any(rec(a) for a in t.args)
        elif op == "iff":
            v = rec(t.args[0]) == rec(t.args[1])
        elif op == "select":
            v = arr_lookup(t.args[0], rec(t.args[1]))
        elif op == "apply":
            table = env.funcs.get(t.params[0], {})
            key = tuple(rec(a) for a in t.args)
            if key in table:
                v = table[key]
            elif env.completion:
                v = 0
            else:
                raise IncompleteModelError(t.params[0])
        else:
            raise NotImplementedError("evaluate: op %s" % op)
        memo[t.uid] = v
        return v

    return rec(term)


def free_symbols(term: Term, _acc=None, _seen=None) -> Dict[str, Term]:
    """All free variable/array/function symbols in a term, keyed by a
    sort-qualified name."""
    acc: Dict[str, Term] = {} if _acc is None else _acc
    seen = set() if _seen is None else _seen
    stack = [term]
    while stack:
        t = stack.pop()
        if t.uid in seen:
            continue
        seen.add(t.uid)
        if t.op in ("var", "boolvar", "array_var"):
            acc[t.op + ":" + t.params[0]] = t
        elif t.op == "apply":
            acc["func:" + t.params[0]] = t
        stack.extend(t.args)
    return acc


def post_order(terms: Iterable[Term]) -> list:
    """Deterministic post-order walk over a term forest (iterative)."""
    out = []
    seen = set()
    stack = [(t, False) for t in reversed(list(terms))]
    while stack:
        t, expanded = stack.pop()
        if t.uid in seen:
            continue
        if expanded:
            seen.add(t.uid)
            out.append(t)
        else:
            stack.append((t, True))
            for a in reversed(t.args):
                if a.uid not in seen:
                    stack.append((a, False))
    return out


def to_sexpr(term: Term, max_depth: int = 50) -> str:
    def rec(t: Term, d: int) -> str:
        if t.op == "const":
            return str(t.params[0]) if t.size != 256 else hex(t.params[0])
        if t.op in ("var", "boolvar", "array_var"):
            return t.params[0]
        if t.op in ("true", "false"):
            return t.op
        if d <= 0:
            return "..."
        inner = " ".join(rec(a, d - 1) for a in t.args)
        extra = ""
        if t.op == "extract":
            extra = " %d %d" % t.params
        elif t.op == "apply":
            extra = " " + t.params[0]
        elif t.op == "const_array":
            extra = " %d" % t.params[2]
        return "(%s%s %s)" % (t.op, extra, inner)

    return rec(term, max_depth)
