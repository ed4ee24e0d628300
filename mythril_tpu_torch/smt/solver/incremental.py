"""Process-global incremental SMT core.

The reference pays Z3 once per query and relies on Z3's internal sharing
(mythril/laser/smt/solver/solver.py:15, state/constraints.py:41 runs a fresh
feasibility check after every fork). Here the whole pipeline is in-repo, so we
can do better than re-blasting the shared path-condition prefix thousands of
times: ONE persistent theory eliminator + Blaster + CDCL instance per process,
with every assertion lowered exactly once (hash-consed term uid -> SAT
literal) and every query solved *under assumptions*. Nothing is ever
retracted; Tseitin definitions and Ackermann congruence axioms are valid
globally, and learned clauses transfer across the whole exploration frontier.

This is the host half of the solver story; the device half (batched
unit-propagation + WalkSAT over CNF tensors) lives in
mythril_tpu_torch/laser/tpu/solver_jax.py and shares compile_cnf() below.
"""

import logging
import time
from typing import Dict, FrozenSet, List, Optional, Tuple

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.solver import pysat
from mythril_tpu_torch.smt.solver.bitblast import Blaster
from mythril_tpu_torch.smt.solver.native import make_sat
from mythril_tpu_torch.smt.solver.preprocess import TheoryEliminator


from mythril_tpu_torch.smt.terms import EvalEnv, Term

log = logging.getLogger(__name__)

# Safety valve: when the accumulated clause database outgrows this, the core
# is rebuilt lazily (caches repopulate on demand from the live term DAG).
CLAUSE_LIMIT = 40_000_000


class LazyCongruenceEliminator(TheoryEliminator):
    """Theory eliminator WITHOUT eager pairwise Ackermann axioms.

    The process-global core accumulates selects/applications from the
    whole analysis; eager pairwise congruence would grow quadratically
    (the round-3 host-engine regression). Instead the core repairs
    congruence lazily: after a SAT answer, violated pairs among the
    query-relevant entries get their axiom asserted and the query is
    re-solved (CEGAR). UNSAT under missing axioms is still sound — the
    formula without them is strictly weaker."""

    def _select_congruence(self, entries, idx, var) -> None:
        pass

    def _apply_congruence(self, entries, args, var) -> None:
        pass


class IncrementalCore:
    def __init__(self) -> None:
        self._fresh_engine()

    def _fresh_engine(self) -> None:
        self.sat = make_sat()
        self.blaster = Blaster(self.sat)
        self.elim = LazyCongruenceEliminator()
        self._side_cursor = 0
        self._congruence_axioms = set()  # (var_uid_a, var_uid_b) pairs done
        # rewritten-term uid -> frozenset of leaf symbol names (bv + bool)
        self._names_cache: Dict[int, FrozenSet[str]] = {}
        self.query_count = 0

    def reset(self) -> None:
        self._fresh_engine()

    def _maybe_recycle(self) -> None:
        if getattr(self.sat, "n_clauses", 0) > CLAUSE_LIMIT:
            log.info("incremental core recycled at %d clauses", self.sat.n_clauses)
            self._fresh_engine()

    # -- lowering ------------------------------------------------------------

    def _drain_side_conditions(self) -> None:
        """Assert congruence side conditions minted by rewriting permanently
        (they are valid axioms, not query-local facts)."""
        while self._side_cursor < len(self.elim.side_conditions):
            sc = self.elim.side_conditions[self._side_cursor]
            self._side_cursor += 1
            self.blaster.assert_formula(sc)

    def lower(self, t: Term) -> Tuple[int, Term]:
        """Rewrite a Bool term to pure QF_BV and blast it; returns the SAT
        literal standing for the term plus the rewritten term."""
        rw = self.elim.rewrite(t)
        self._drain_side_conditions()
        return self.blaster.lit(rw), rw

    def word(self, t: Term) -> Tuple[List[int], Term]:
        """Same as lower() for a bitvector term: its bit literals."""
        rw = self.elim.rewrite(t)
        self._drain_side_conditions()
        return self.blaster.word(rw), rw

    # -- solving -------------------------------------------------------------

    def solve(
        self,
        assumptions: List[int],
        timeout_ms: Optional[int] = None,
        conflict_budget: Optional[int] = None,
    ) -> int:
        self.query_count += 1
        return self.sat.solve(
            assumptions=assumptions,
            timeout_ms=timeout_ms,
            conflict_budget=conflict_budget,
        )

    # -- model extraction ----------------------------------------------------

    def _leaf_names(self, rw: Term) -> FrozenSet[Tuple[str, str, int]]:
        """Leaf symbols of a rewritten term as (kind, name, size) triples,
        kind 'bv' or 'bool' (size 0 for bools) — sizes matter because the
        process-global blaster distinguishes same-named vars by width."""
        got = self._names_cache.get(rw.uid)
        if got is not None:
            return got
        acc = set()
        stack = [rw]
        seen = set()
        while stack:
            t = stack.pop()
            if t.uid in seen:
                continue
            seen.add(t.uid)
            cached = self._names_cache.get(t.uid)
            if cached is not None:
                acc.update(cached)
                continue
            if t.op == "var":
                acc.add(("bv", t.params[0], t.size))
            elif t.op == "boolvar":
                acc.add(("bool", t.params[0], 0))
            stack.extend(t.args)
        result = frozenset(acc)
        self._names_cache[rw.uid] = result
        return result

    def _read_word(self, bits: List[int], assign) -> int:
        value = 0
        n = len(assign)
        for i, lit in enumerate(bits):
            v = abs(lit)
            val = assign[v] if v < n else -1
            if val == 0:
                val = -1
            if lit < 0:
                val = -val
            if val == 1:
                value |= 1 << i
        return value

    @staticmethod
    def _var_key(var_term: Term) -> Tuple[str, str, int]:
        return ("bv", var_term.params[0], var_term.size)

    def _relevance(self, query_rws: List[Term]):
        """(relevant leaf set, relevant array names, relevant func names):
        the query terms' leaves, transitively closed over the Ackermann
        entries of every array/function any leaf belongs to."""
        relevant = set()
        for rw in query_rws:
            relevant.update(self._leaf_names(rw))
        info = self.elim.info
        included_arrays: Dict[str, bool] = {}
        included_funcs: Dict[str, bool] = {}
        changed = True
        while changed:
            changed = False
            for name, entries in info.arrays.items():
                if included_arrays.get(name):
                    continue
                if any(self._var_key(var) in relevant for _, var in entries):
                    included_arrays[name] = True
                    for idx_term, var_term in entries:
                        relevant.add(self._var_key(var_term))
                        relevant.update(self._leaf_names(idx_term))
                    changed = True
            for name, entries in info.funcs.items():
                if included_funcs.get(name):
                    continue
                if any(self._var_key(var) in relevant for _, var in entries):
                    included_funcs[name] = True
                    for arg_terms, var_term in entries:
                        relevant.add(self._var_key(var_term))
                        for a in arg_terms:
                            relevant.update(self._leaf_names(a))
                    changed = True
        return relevant, included_arrays, included_funcs

    def _model_values(self, relevant) -> Tuple[Dict, Dict]:
        assign = self.sat.model_copy()
        bv_values: Dict = {}
        bool_values: Dict = {}
        blaster = self.blaster
        for kind, name, size in relevant:
            if kind == "bv":
                bits = blaster.var_bits.get((name, size))
                if bits is not None:
                    word = self._read_word(bits, assign)
                    bv_values[(name, size)] = word
                    bv_values.setdefault(name, word)
                continue
            lit = blaster.bool_vars.get(name)
            if lit is not None:
                v = abs(lit)
                val = assign[v] if v < len(assign) else -1
                if val == 0:
                    val = -1
                bool_values[name] = (val == 1) if lit > 0 else (val == -1)
        return bv_values, bool_values

    # -- lazy congruence (CEGAR) ----------------------------------------------

    def solve_checked(
        self,
        lits: List[int],
        query_rws: List[Term],
        timeout_ms: Optional[int] = None,
        conflict_budget: Optional[int] = None,
        max_repair_rounds: int = 24,
    ) -> int:
        """Solve under assumptions, repairing violated Ackermann
        congruence among the query-relevant entries until the model is
        consistent (or rounds run out -> UNKNOWN).

        ``timeout_ms`` bounds the WHOLE loop, not each round: a repair
        loop of N rounds each granted the full budget overshot
        feasibility checks ~5x (profiled: 100ms budgets averaging 540ms
        per is_possible on multiplier-heavy constraints)."""
        deadline = (
            time.monotonic() + timeout_ms / 1000.0 if timeout_ms else None
        )
        for _ in range(max_repair_rounds):
            round_ms = timeout_ms
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return pysat.UNKNOWN
                round_ms = max(1, int(remaining * 1000))
            code = self.solve(
                lits, timeout_ms=round_ms, conflict_budget=conflict_budget
            )
            if code != pysat.SAT:
                return code
            if not self._repair_congruence(query_rws):
                return pysat.SAT
        return pysat.UNKNOWN

    def _repair_congruence(self, query_rws: List[Term]) -> bool:
        """Assert axioms for congruence violations the current model shows
        among relevant entries; True if anything was added."""
        relevant, arrays, funcs = self._relevance(query_rws)
        bv_values, bool_values = self._model_values(relevant)
        env0 = EvalEnv(bv_values, bool_values, {}, {}, completion=True)
        info = self.elim.info
        repaired = False

        for name in arrays:
            by_index: Dict[int, Tuple[Term, Term, int]] = {}
            for idx_term, var_term in info.arrays[name]:
                idx_val = terms.evaluate(idx_term, env0)
                var_val = bv_values.get(var_term.params[0], 0)
                first = by_index.get(idx_val)
                if first is None:
                    by_index[idx_val] = (idx_term, var_term, var_val)
                    continue
                f_idx, f_var, f_val = first
                if f_val == var_val:
                    continue
                pair = tuple(sorted((f_var.uid, var_term.uid)))
                if pair in self._congruence_axioms:
                    continue
                self._congruence_axioms.add(pair)
                self.blaster.assert_formula(
                    terms.bool_or(
                        terms.bool_not(terms.bool_eq(f_idx, idx_term)),
                        terms.bool_eq(f_var, var_term),
                    )
                )
                repaired = True
        for name in funcs:
            by_args: Dict[Tuple, Tuple[Tuple, Term, int]] = {}
            for arg_terms, var_term in info.funcs[name]:
                args_val = tuple(terms.evaluate(a, env0) for a in arg_terms)
                var_val = bv_values.get(var_term.params[0], 0)
                first = by_args.get(args_val)
                if first is None:
                    by_args[args_val] = (arg_terms, var_term, var_val)
                    continue
                f_args, f_var, f_val = first
                if f_val == var_val:
                    continue
                pair = tuple(sorted((f_var.uid, var_term.uid)))
                if pair in self._congruence_axioms:
                    continue
                self._congruence_axioms.add(pair)
                same_args = terms.bool_and(
                    *[terms.bool_eq(pa, a) for pa, a in zip(f_args, arg_terms)]
                )
                self.blaster.assert_formula(
                    terms.bool_or(
                        terms.bool_not(same_args), terms.bool_eq(f_var, var_term)
                    )
                )
                repaired = True
        return repaired

    def extract_env(self, query_rws: List[Term]) -> EvalEnv:
        """EvalEnv restricted to query-relevant symbols (congruent after
        solve_checked's repair loop converged)."""
        relevant, included_arrays, included_funcs = self._relevance(query_rws)
        assign = self.sat.model_copy()

        bv_values = {}
        bool_values = {}
        blaster = self.blaster
        for kind, name, size in relevant:
            if kind == "bv":
                bits = blaster.var_bits.get((name, size))
                if bits is not None:
                    word = self._read_word(bits, assign)
                    # (name, size) key first — same-named vars of different
                    # widths are distinct symbols (terms.evaluate prefers
                    # the sized key); plain name kept for compatibility
                    bv_values[(name, size)] = word
                    bv_values.setdefault(name, word)
                continue
            lit = blaster.bool_vars.get(name)
            if lit is not None:
                v = abs(lit)
                val = assign[v] if v < len(assign) else -1
                if val == 0:
                    val = -1
                bool_values[name] = (val == 1) if lit > 0 else (val == -1)

        env0 = EvalEnv(bv_values, bool_values, {}, {}, completion=True)
        info = self.elim.info
        arrays = {}
        for name in included_arrays:
            store = {}
            for idx_term, var_term in info.arrays[name]:
                idx_val = terms.evaluate(idx_term, env0)
                store[idx_val] = bv_values.get(var_term.params[0], 0)
            arrays[name] = (store, 0)
        funcs = {}
        for name in included_funcs:
            table = {}
            for arg_terms, var_term in info.funcs[name]:
                key = tuple(terms.evaluate(a, env0) for a in arg_terms)
                table[key] = bv_values.get(var_term.params[0], 0)
            funcs[name] = table
        return EvalEnv(bv_values, bool_values, arrays, funcs, completion=True)


_core: Optional[IncrementalCore] = None


def get_core() -> IncrementalCore:
    global _core
    if _core is None:
        _core = IncrementalCore()
    else:
        _core._maybe_recycle()
    return _core


def reset_core() -> None:
    """Drop the global core (tests / long-running servers)."""
    global _core
    _core = None
