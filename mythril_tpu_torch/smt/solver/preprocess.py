"""Theory elimination: arrays and uninterpreted functions -> pure QF_BV.

Pipeline (standard, but implemented over our term DAG):
1. Store chains are eliminated by pushing selects through stores:
     select(store(a, i, v), j) -> ite(i == j, v, select(a, j))
   (terms.array_select already folds the concrete cases at construction).
2. Remaining selects on base arrays and UF applications are Ackermannized:
   each distinct application becomes a fresh variable plus pairwise
   congruence axioms.

The output is a list of pure-bitvector assertions plus reconstruction info
used to build array/function models from the SAT assignment.

Reference behavior being replaced: z3's internal array/UF reasoning used via
mythril/laser/smt/solver/solver.py.
"""

from typing import Dict, List, Tuple

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.terms import Term


class AckInfo:
    """Reconstruction info from Ackermannization.

    arrays: base-array name -> list of (rewritten_index_term, fresh_var_term)
    funcs:  function name -> list of (tuple_of_rewritten_arg_terms, fresh_var_term)
    """

    def __init__(self) -> None:
        self.arrays: Dict[str, List[Tuple[Term, Term]]] = {}
        self.funcs: Dict[str, List[Tuple[Tuple[Term, ...], Term]]] = {}


class TheoryEliminator:
    def __init__(self) -> None:
        self.memo: Dict[int, Term] = {}
        self.sel_vars: Dict[Tuple[int, int], Term] = {}  # (base arr uid, idx uid)
        self.app_vars: Dict[Tuple[str, Tuple[int, ...]], Term] = {}
        self.info = AckInfo()
        self.side_conditions: List[Term] = []
        self._fresh = 0

    def _fresh_var(self, prefix: str, size: int) -> Term:
        self._fresh += 1
        return terms.bv_var("!%s!%d" % (prefix, self._fresh), size)

    def _select_congruence(self, entries, idx: Term, var: Term) -> None:
        """Eager pairwise congruence with earlier selects of the array.
        Subclasses may defer this (model-driven lazy congruence) — the
        quadratic axiom count is fine per query but not process-wide.

        Vacuous pairs are pruned: two selects at DISTINCT CONSTANT
        indices can never alias, so their axiom is a tautology.
        (Identical constants hash-cons to the same uid and dedup through
        ``sel_vars`` before reaching here.) EVM workloads index almost
        exclusively by constant calldata/storage offsets, so this turns
        the quadratic axiom sweep into a near-no-op — measured 27.8 s of
        a 60 s BECToken profile before, dominated by 3.7M bool_eq
        constructions."""
        idx_is_const = idx.op == "const"
        for prev_idx, prev_var in entries:
            if idx_is_const and prev_idx.op == "const":
                continue  # provably distinct: axiom vacuous
            self.side_conditions.append(
                terms.bool_or(
                    terms.bool_not(terms.bool_eq(prev_idx, idx)),
                    terms.bool_eq(prev_var, var),
                )
            )

    def _apply_congruence(self, entries, args, var: Term) -> None:
        """Eager pairwise congruence with earlier applications of the UF.
        Pairs differing in some constant argument position are provably
        incongruent — their axiom is vacuous and skipped (same pruning
        as _select_congruence)."""
        for prev_args, prev_var in entries:
            if any(
                pa.op == "const" and a.op == "const" and pa.uid != a.uid
                for pa, a in zip(prev_args, args)
            ):
                continue
            same_args = terms.bool_and(
                *[terms.bool_eq(pa, a) for pa, a in zip(prev_args, args)]
            )
            self.side_conditions.append(
                terms.bool_or(
                    terms.bool_not(same_args), terms.bool_eq(prev_var, var)
                )
            )

    def _select_base(self, base: Term, idx: Term) -> Term:
        """Ackermannize a select on a base array (array_var)."""
        key = (base.uid, idx.uid)
        got = self.sel_vars.get(key)
        if got is not None:
            return got
        name = base.params[0]
        var = self._fresh_var("sel_" + name, base.size)
        entries = self.info.arrays.setdefault(name, [])
        self._select_congruence(entries, idx, var)
        entries.append((idx, var))
        self.sel_vars[key] = var
        return var

    def _select(self, arr: Term, idx: Term) -> Term:
        """Push a (rewritten-index) select through a store chain."""
        node = arr
        # collect stores top-down, then build the ite chain bottom-up
        stores: List[Tuple[Term, Term]] = []
        while node.op == "store":
            stores.append((self.rewrite(node.args[1]), self.rewrite(node.args[2])))
            node = node.args[0]
        if node.op == "const_array":
            result = terms.bv_const(node.params[2], node.size)
        elif node.op == "array_var":
            result = self._select_base(node, idx)
        else:
            raise NotImplementedError("array base op %s" % node.op)
        for sidx, sval in reversed(stores):
            result = terms.bv_ite(terms.bool_eq(sidx, idx), sval, result)
        return result

    def rewrite(self, t: Term) -> Term:
        got = self.memo.get(t.uid)
        if got is not None:
            return got
        if t.op == "select":
            idx = self.rewrite(t.args[1])
            out = self._select(t.args[0], idx)
        elif t.op == "apply":
            name, domain, rng = t.params
            args = tuple(self.rewrite(a) for a in t.args)
            key = (name, tuple(a.uid for a in args))
            if key in self.app_vars:
                out = self.app_vars[key]
            else:
                var = self._fresh_var("uf_" + name, rng)
                entries = self.info.funcs.setdefault(name, [])
                self._apply_congruence(entries, args, var)
                entries.append((args, var))
                self.app_vars[key] = var
                out = var
        elif not t.args:
            out = t
        else:
            new_args = tuple(self.rewrite(a) for a in t.args)
            if all(n is o for n, o in zip(new_args, t.args)):
                out = t
            else:
                out = _rebuild(t, new_args)
        self.memo[t.uid] = out
        return out


def _rebuild(t: Term, args: Tuple[Term, ...]) -> Term:
    op = t.op
    if op in terms._BIN_FOLDS:
        ctor = {
            "add": terms.bv_add, "sub": terms.bv_sub, "mul": terms.bv_mul,
            "udiv": terms.bv_udiv, "sdiv": terms.bv_sdiv, "urem": terms.bv_urem,
            "srem": terms.bv_srem, "and": terms.bv_and, "or": terms.bv_or,
            "xor": terms.bv_xor, "shl": terms.bv_shl, "lshr": terms.bv_lshr,
            "ashr": terms.bv_ashr,
        }[op]
        return ctor(args[0], args[1])
    if op == "not":
        return terms.bv_not(args[0])
    if op == "neg":
        return terms.bv_neg(args[0])
    if op == "concat":
        return terms.bv_concat(args)
    if op == "extract":
        return terms.bv_extract(t.params[0], t.params[1], args[0])
    if op == "zext":
        return terms.bv_zext(t.params[0], args[0])
    if op == "sext":
        return terms.bv_sext(t.params[0], args[0])
    if op == "ite":
        return terms.bv_ite(args[0], args[1], args[2])
    if op == "eq":
        return terms.bool_eq(args[0], args[1])
    if op == "ult":
        return terms.bool_ult(args[0], args[1])
    if op == "ule":
        return terms.bool_ule(args[0], args[1])
    if op == "slt":
        return terms.bool_slt(args[0], args[1])
    if op == "sle":
        return terms.bool_sle(args[0], args[1])
    if op == "bnot":
        return terms.bool_not(args[0])
    if op == "band":
        return terms.bool_and(*args)
    if op == "bor":
        return terms.bool_or(*args)
    if op == "iff":
        return terms.bool_iff(args[0], args[1])
    if op == "store":
        return terms.array_store(args[0], args[1], args[2])
    raise NotImplementedError("rebuild: op %s" % op)


def eliminate_theories(assertions: List[Term]):
    """Returns (pure_bv_assertions, AckInfo)."""
    elim = TheoryEliminator()
    rewritten = [elim.rewrite(a) for a in assertions]
    rewritten.extend(elim.side_conditions)
    return rewritten, elim.info
