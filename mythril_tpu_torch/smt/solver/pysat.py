"""A compact CDCL SAT solver in pure Python.

This is the portable fallback engine behind the SMT facade; the default
engine is the native C++ twin (mythril_tpu_torch/csrc/tsat.cpp) loaded via ctypes
(mythril_tpu_torch/smt/solver/native.py), which implements the same interface.

Features: two-watched-literal propagation, VSIDS-style activity, first-UIP
conflict learning, phase saving, Luby restarts, incremental solving under
assumptions (MiniSat-style: assumptions are the first decision levels),
wall-clock + conflict budgets.

Literal encoding: DIMACS-style signed ints (var ids from 1).
"""

import time
from typing import Dict, Iterable, List, Optional

SAT = 10
UNSAT = 20
UNKNOWN = 0


def _luby(x: int) -> int:
    """Canonical iterative Luby sequence, x >= 0: 1,1,2,1,1,2,4,..."""
    size, seq = 1, 0
    while size < x + 1:
        seq += 1
        size = 2 * size + 1
    while size - 1 != x:
        size = (size - 1) >> 1
        seq -= 1
        x = x % size
    return 1 << seq


class PySat:
    def __init__(self) -> None:
        self.nvars = 0
        self.clauses: List[List[int]] = []
        self.watches: Dict[int, List[int]] = {}
        self.assign: List[int] = [0]  # var -> 0 / 1 (true) / -1 (false)
        self.level: List[int] = [0]
        self.reason: List[Optional[int]] = [None]
        self.activity: List[float] = [0.0]
        self.phase: List[int] = [0]
        self.trail: List[int] = []
        self.trail_lim: List[int] = []
        self.qhead = 0
        self.var_inc = 1.0
        self.ok = True
        self.n_clauses = 0

    # -- variables / clauses -------------------------------------------------

    def new_var(self) -> int:
        self.nvars += 1
        self.assign.append(0)
        self.level.append(0)
        self.reason.append(None)
        self.activity.append(0.0)
        self.phase.append(-1)
        return self.nvars

    def ensure_var(self, v: int) -> None:
        while self.nvars < v:
            self.new_var()

    def value(self, lit: int) -> int:
        v = self.assign[abs(lit)]
        return v if lit > 0 else -v

    def add_clause(self, lits: Iterable[int]) -> None:
        """Add a clause (backtracks to decision level 0 first)."""
        self.n_clauses += 1
        if not self.ok:
            return
        self._cancel_until(0)
        seen = set()
        clause = []
        for lit in lits:
            self.ensure_var(abs(lit))
            if -lit in seen:
                return  # tautology
            if lit in seen:
                continue
            if self.value(lit) == 1:
                return  # satisfied at root
            if self.value(lit) == -1:
                continue  # falsified at root
            seen.add(lit)
            clause.append(lit)
        if not clause:
            self.ok = False
            return
        if len(clause) == 1:
            if not self._root_assign(clause[0]):
                self.ok = False
            return
        self._attach(clause)

    def _attach(self, clause: List[int]) -> int:
        idx = len(self.clauses)
        self.clauses.append(clause)
        self.watches.setdefault(clause[0], []).append(idx)
        self.watches.setdefault(clause[1], []).append(idx)
        return idx

    # -- trail ---------------------------------------------------------------

    def _root_assign(self, lit: int) -> bool:
        if self.value(lit) == -1:
            return False
        if self.value(lit) == 1:
            return True
        self._enqueue(lit, None)
        return self._propagate() is None

    def _enqueue(self, lit: int, reason: Optional[int]) -> None:
        v = abs(lit)
        self.assign[v] = 1 if lit > 0 else -1
        self.level[v] = len(self.trail_lim)
        self.reason[v] = reason
        self.phase[v] = 1 if lit > 0 else -1
        self.trail.append(lit)

    def _propagate(self) -> Optional[int]:
        """Unit propagation; returns the index of a conflicting clause."""
        while self.qhead < len(self.trail):
            lit = self.trail[self.qhead]
            self.qhead += 1
            false_lit = -lit
            watchlist = self.watches.get(false_lit)
            if not watchlist:
                continue
            i = 0
            while i < len(watchlist):
                ci = watchlist[i]
                clause = self.clauses[ci]
                if clause[0] == false_lit:
                    clause[0], clause[1] = clause[1], clause[0]
                first = clause[0]
                if self.value(first) == 1:
                    i += 1
                    continue
                moved = False
                for k in range(2, len(clause)):
                    if self.value(clause[k]) != -1:
                        clause[1], clause[k] = clause[k], clause[1]
                        self.watches.setdefault(clause[1], []).append(ci)
                        watchlist[i] = watchlist[-1]
                        watchlist.pop()
                        moved = True
                        break
                if moved:
                    continue
                if self.value(first) == -1:
                    self.qhead = len(self.trail)
                    return ci
                self._enqueue(first, ci)
                i += 1
        return None

    # -- conflict analysis (first UIP) ---------------------------------------

    def _bump(self, v: int) -> None:
        self.activity[v] += self.var_inc
        if self.activity[v] > 1e100:
            for u in range(1, self.nvars + 1):
                self.activity[u] *= 1e-100
            self.var_inc *= 1e-100

    def _analyze(self, confl: int):
        cur_level = len(self.trail_lim)
        learnt = [0]
        seen = set()
        counter = 0
        index = len(self.trail) - 1
        asserting_lit = None  # literal whose reason we are expanding
        while True:
            clause = self.clauses[confl]
            for q in clause:
                if asserting_lit is not None and q == asserting_lit:
                    continue
                v = abs(q)
                if v not in seen and self.level[v] > 0:
                    seen.add(v)
                    self._bump(v)
                    if self.level[v] >= cur_level:
                        counter += 1
                    else:
                        learnt.append(q)
            while abs(self.trail[index]) not in seen:
                index -= 1
            asserting_lit = self.trail[index]
            index -= 1
            v = abs(asserting_lit)
            seen.discard(v)
            counter -= 1
            if counter == 0:
                learnt[0] = -asserting_lit
                break
            confl = self.reason[v]  # type: ignore[assignment]
        if len(learnt) == 1:
            bt = 0
        else:
            max_i = 1
            for i in range(2, len(learnt)):
                if self.level[abs(learnt[i])] > self.level[abs(learnt[max_i])]:
                    max_i = i
            learnt[1], learnt[max_i] = learnt[max_i], learnt[1]
            bt = self.level[abs(learnt[1])]
        return learnt, bt

    def _cancel_until(self, lvl: int) -> None:
        while len(self.trail_lim) > lvl:
            lim = self.trail_lim.pop()
            for lit in self.trail[lim:]:
                v = abs(lit)
                self.assign[v] = 0
                self.reason[v] = None
            del self.trail[lim:]
        if len(self.trail_lim) == 0:
            self.qhead = min(self.qhead, len(self.trail))
        else:
            self.qhead = len(self.trail)

    def _decide(self) -> int:
        best_v, best_a = 0, -1.0
        for v in range(1, self.nvars + 1):
            if self.assign[v] == 0 and self.activity[v] > best_a:
                best_v, best_a = v, self.activity[v]
        if best_v == 0:
            return 0
        return best_v if self.phase[best_v] >= 0 else -best_v

    # -- main ----------------------------------------------------------------

    def solve(
        self,
        assumptions: Optional[List[int]] = None,
        timeout_ms: Optional[int] = None,
        conflict_budget: Optional[int] = None,
    ) -> int:
        if not self.ok:
            return UNSAT
        assumptions = list(assumptions or [])
        for lit in assumptions:
            self.ensure_var(abs(lit))
        deadline = time.monotonic() + timeout_ms / 1000.0 if timeout_ms else None
        conflicts = 0
        restart_idx = 0
        restart_limit = 64 * _luby(restart_idx)
        self._cancel_until(0)
        if self._propagate() is not None:
            self.ok = False
            return UNSAT
        n_assumptions = len(assumptions)
        while True:
            confl = self._propagate()
            if confl is not None:
                conflicts += 1
                if len(self.trail_lim) == 0:
                    self.ok = False
                    return UNSAT
                if len(self.trail_lim) <= n_assumptions:
                    # conflict while only assumptions are on the trail
                    self._cancel_until(0)
                    return UNSAT
                learnt, bt = self._analyze(confl)
                self._cancel_until(min(bt, len(self.trail_lim) - 1))
                if len(learnt) == 1:
                    if len(self.trail_lim) == 0:
                        if not self._root_assign(learnt[0]):
                            self.ok = False
                            return UNSAT
                    elif self.value(learnt[0]) == 0:
                        self._enqueue(learnt[0], None)
                else:
                    ci = self._attach(learnt)
                    if self.value(learnt[0]) == 0:
                        self._enqueue(learnt[0], ci)
                self.var_inc /= 0.95
                if conflict_budget is not None and conflicts > conflict_budget:
                    self._cancel_until(0)
                    return UNKNOWN
                if deadline is not None and conflicts % 64 == 0 and time.monotonic() > deadline:
                    self._cancel_until(0)
                    return UNKNOWN
                if conflicts >= restart_limit:
                    restart_idx += 1
                    restart_limit = conflicts + 64 * _luby(restart_idx)
                    self._cancel_until(0)
            else:
                if len(self.trail_lim) < len(assumptions):
                    # place the next assumption as a decision
                    lit = assumptions[len(self.trail_lim)]
                    if self.value(lit) == -1:
                        self._cancel_until(0)
                        return UNSAT
                    self.trail_lim.append(len(self.trail))
                    if self.value(lit) == 0:
                        self._enqueue(lit, None)
                    continue
                lit = self._decide()
                if lit == 0:
                    return SAT
                self.trail_lim.append(len(self.trail))
                self._enqueue(lit, None)

    def model_value(self, var: int) -> int:
        """After SAT: 1/-1 for the var's value (unassigned vars default -1)."""
        if var > self.nvars or self.assign[var] == 0:
            return -1
        return self.assign[var]

    def model_copy(self) -> List[int]:
        """Whole assignment, 1-based (index 0 unused): 1/-1/0 per var."""
        return list(self.assign)
