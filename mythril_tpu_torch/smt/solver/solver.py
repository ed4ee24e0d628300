"""Solver facade (reference surface: mythril/laser/smt/solver/solver.py).

check() routes through the process-global incremental core
(smt/solver/incremental.py): theory elimination and bit-blasting are cached
per hash-consed term for the lifetime of the process, and every query is a
single CDCL solve under assumptions, so the shared prefix of a fork's path
condition costs nothing after its first appearance. Optimize implements
lexicographic minimize/maximize by binary search with assumption-gated bound
circuits (replacing z3.Optimize) — bounds are plain gate literals passed as
assumptions, so nothing query-local ever pollutes the shared clause database.
"""

import logging
import time
from typing import List, Optional, Tuple

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.bitvec import BitVec
from mythril_tpu_torch.smt.bool_ import Bool
from mythril_tpu_torch.smt.model import Model
from mythril_tpu_torch.smt.solver import pysat
from mythril_tpu_torch.smt.solver.bitblast import BlastError
from mythril_tpu_torch.smt.solver.incremental import get_core
from mythril_tpu_torch.smt.solver.solver_statistics import stat_smt_query
from mythril_tpu_torch.smt.terms import EvalEnv

log = logging.getLogger(__name__)


class CheckResult:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return self.name


sat = CheckResult("sat")
unsat = CheckResult("unsat")
unknown = CheckResult("unknown")

_RESULT_BY_CODE = {pysat.SAT: sat, pysat.UNSAT: unsat, pysat.UNKNOWN: unknown}


class BaseSolver:
    def __init__(self) -> None:
        self.constraints: List[Bool] = []
        self.timeout: Optional[int] = None  # milliseconds
        self.conflict_budget: Optional[int] = None
        self._model_env: Optional[EvalEnv] = None

    def set_timeout(self, timeout: int) -> None:
        """Set the timeout for the solver, in milliseconds."""
        self.timeout = timeout

    def add(self, *constraints) -> None:
        """Assert constraints (Bool wrappers, possibly nested in lists)."""
        for c in constraints:
            if isinstance(c, (list, tuple)):
                self.add(*c)
            elif isinstance(c, Bool):
                self.constraints.append(c)
            elif isinstance(c, bool):
                self.constraints.append(Bool(terms.bool_const(c)))
            else:
                raise TypeError("cannot assert %r" % (c,))

    def append(self, *constraints) -> None:
        self.add(*constraints)

    def reset(self) -> None:
        self.constraints = []
        self._model_env = None

    # -- shared plumbing -----------------------------------------------------

    def _gather(self, extra_constraints) -> List[terms.Term]:
        extras: List[Bool] = []
        for c in extra_constraints:
            if isinstance(c, (list, tuple)):
                extras.extend(c)
            else:
                extras.append(c)
        return [c.raw for c in self.constraints] + [c.raw for c in extras]

    @staticmethod
    def _lower_all(core, all_terms) -> Optional[Tuple[List[int], List[terms.Term]]]:
        lits: List[int] = []
        rws: List[terms.Term] = []
        try:
            for t in all_terms:
                lit, rw = core.lower(t)
                lits.append(lit)
                rws.append(rw)
        except BlastError as e:
            log.warning("bit-blasting failed: %s", e)
            return None
        return lits, rws

    @stat_smt_query
    def check(self, *extra_constraints) -> CheckResult:
        """Returns sat/unsat/unknown for the asserted constraint set."""
        self._model_env = None
        all_terms = self._gather(extra_constraints)
        # fast path: constant conflicts never reach the SAT solver
        if any(t is terms.FALSE for t in all_terms):
            return unsat
        if all(t is terms.TRUE for t in all_terms):
            self._model_env = EvalEnv()
            return sat
        # fetch the core ONCE per check: get_core() may recycle the engine,
        # which would orphan literals minted by an earlier fetch
        core = get_core()
        lowered = self._lower_all(core, all_terms)
        if lowered is None:
            return unknown
        lits, rws = lowered
        code = core.solve_checked(
            lits, rws, timeout_ms=self.timeout, conflict_budget=self.conflict_budget
        )
        if code == pysat.SAT:
            self._model_env = core.extract_env(rws)
        return _RESULT_BY_CODE[code]

    def model(self) -> Model:
        """The model for the last sat check()."""
        if self._model_env is None:
            return Model()
        return Model([self._model_env])


class Solver(BaseSolver):
    """Plain solver."""


class Optimize(BaseSolver):
    """Solver with lexicographic minimize/maximize objectives."""

    def __init__(self) -> None:
        super().__init__()
        self._objectives: List[tuple] = []  # (term, is_minimize)

    def minimize(self, element: BitVec) -> None:
        self._objectives.append((element.raw, True))

    def maximize(self, element: BitVec) -> None:
        self._objectives.append((element.raw, False))

    @stat_smt_query
    def check(self, *extra_constraints) -> CheckResult:
        self._model_env = None
        all_terms = self._gather(extra_constraints)
        if any(t is terms.FALSE for t in all_terms):
            return unsat
        deadline = time.monotonic() + self.timeout / 1000.0 if self.timeout else None

        def remaining_ms() -> Optional[int]:
            if deadline is None:
                return None
            return max(1, int((deadline - time.monotonic()) * 1000))

        core = get_core()
        lowered = self._lower_all(core, all_terms)
        if lowered is None:
            return unknown
        lits, rws = lowered
        obj_words = []
        obj_rws = []
        try:
            for obj_term, _ in self._objectives:
                bits, rw = core.word(obj_term)
                obj_words.append(bits)
                obj_rws.append(rw)
        except BlastError as e:
            log.warning("bit-blasting objective failed: %s", e)
            obj_words, obj_rws = [], []

        env_rws = rws + obj_rws
        code = core.solve_checked(
            lits,
            env_rws,
            timeout_ms=remaining_ms(),
            conflict_budget=self.conflict_budget,
        )
        if code != pysat.SAT:
            return _RESULT_BY_CODE[code]
        self._model_env = core.extract_env(env_rws)
        if not obj_words:
            return sat

        # lexicographic binary search; bound/pin circuits are gate literals
        # used purely as assumptions, so the shared database stays clean.
        blaster = core.blaster
        pins: List[int] = []
        for (obj_term, is_min), obj_bits, obj_rw in zip(
            self._objectives, obj_words, obj_rws
        ):
            current = terms.evaluate(obj_rw, self._model_env)
            lo, hi = (0, current) if is_min else (current, terms.mask(obj_rw.size))
            while lo < hi:
                if deadline is not None and time.monotonic() > deadline:
                    break
                mid = (lo + hi) // 2 if is_min else (lo + hi + 1) // 2
                bound = blaster.const_word(mid, len(obj_bits))
                if is_min:
                    cond = -blaster.w_ult(bound, obj_bits)  # obj <= mid
                else:
                    cond = -blaster.w_ult(obj_bits, bound)  # obj >= mid
                code = core.solve_checked(
                    lits + pins + [cond],
                    env_rws,
                    timeout_ms=remaining_ms(),
                    conflict_budget=self.conflict_budget,
                )
                if code == pysat.SAT:
                    self._model_env = core.extract_env(env_rws)
                    val = terms.evaluate(obj_rw, self._model_env)
                    if is_min:
                        hi = min(val, mid)
                    else:
                        lo = max(val, mid)
                elif code == pysat.UNSAT:
                    if is_min:
                        lo = mid + 1
                    else:
                        hi = mid - 1
                else:
                    break
            # pin the achieved optimum before the next objective
            best = terms.evaluate(obj_rw, self._model_env)
            pins.append(blaster.w_eq(obj_bits, blaster.const_word(best, len(obj_bits))))
        return sat
