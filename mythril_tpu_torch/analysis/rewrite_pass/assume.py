"""Assumption-based incrementality helpers (docs/REWRITE_PASS.md).

Two mechanisms ride the rewrite pass, both exploiting the append-only
structure of fork-child constraint lists:

* **witness reuse** — a fork child extends its parent's constraint
  prefix, and the parent's SAT witness (the named-symbol model the
  device kernel or host core produced) is cached by path-prefix
  fingerprint. Before any solve, the child's FULL rewritten set is
  concretely evaluated under that witness (``terms.evaluate`` — the
  semantics oracle, zero-completion for symbols the witness lacks): if
  every member evaluates true, the witness is a satisfying assignment
  of the child too and the query is answered without blasting a single
  clause. Sound unconditionally — any total assignment that makes every
  conjunct true IS a model.

* **UNSAT core minimization** — the host incremental core solves under
  assumption literals over a shared blast state, so re-solving a PREFIX
  of an UNSAT set costs assumption flips only, nothing is re-blasted.
  The SAT backends expose no failed-assumption API, so the shortest
  UNSAT prefix is found by bisection (UNSAT-ness of prefixes is
  monotone: extending a conjunction can only remove models). The
  minimized prefix feeds the memo as a subsumption seed — a
  shorter UNSAT set subsumes strictly more supersets — and a
  single-term core additionally enters the process-global known-unsat
  uid set the bridge consults as a static prune fact (hash-consing
  makes uid membership equal structural identity, so any set containing
  that term is UNSAT by monotonicity).
"""

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.solver import pysat
from mythril_tpu_torch.smt.terms import EvalEnv, Term

# uids of terms proven single-handedly UNSAT (structurally — never from
# seeded interval facts; see engine.RewriteOutcome.core_is_structural).
# Consulted by laser/tpu/backend.filter_feasible next to the bridge's
# jumpi_verdict contradiction flag: a lane whose path condition contains
# a known self-contradictory term is static-UNSAT before any solve.
_known_unsat_uids: set = set()
_known_lock = threading.Lock()
KNOWN_UNSAT_CAP = 4096

# bisection probe budget: each probe is an assumption-only re-solve on
# the warm core (nothing re-blasted), budgeted tightly — minimization
# is an optimization and must never dominate the solve it follows
CORE_PROBE_TIMEOUT_MS = 50
CORE_MAX_PROBES = 8


def note_unsat_term(t: Term) -> None:
    """Record a term proven UNSAT on its own (structural proofs only)."""
    with _known_lock:
        if len(_known_unsat_uids) < KNOWN_UNSAT_CAP:
            _known_unsat_uids.add(t.uid)


def known_unsat_uid(uid: int) -> bool:
    with _known_lock:
        return uid in _known_unsat_uids


def any_known_unsat(uids) -> bool:
    """True when any uid in ``uids`` names a known self-UNSAT term."""
    with _known_lock:
        if not _known_unsat_uids:
            return False
        return any(u in _known_unsat_uids for u in uids)


def known_unsat_count() -> int:
    with _known_lock:
        return len(_known_unsat_uids)


def reset_known_unsat() -> None:
    with _known_lock:
        _known_unsat_uids.clear()


# ---------------------------------------------------------------------------
# witness reuse
# ---------------------------------------------------------------------------


def model_env(model: Dict) -> EvalEnv:
    """EvalEnv from a cached named-symbol model (solver_jax format:
    ("bv", name, size) -> int, ("bool", name) -> bool). Completion stays
    on: symbols the witness lacks default to zero, and a total
    assignment satisfying every conjunct is a model regardless of where
    its values came from."""
    bv_values: Dict = {}
    bool_values: Dict = {}
    for key, val in model.items():
        if not isinstance(key, tuple):
            continue
        if key[0] == "bv" and len(key) == 3:
            bv_values[(key[1], key[2])] = val
        elif key[0] == "bool" and len(key) == 2:
            bool_values[key[1]] = val
    return EvalEnv(bv_values=bv_values, bool_values=bool_values)


def try_witness(raw_terms: Sequence[Term], model: Optional[Dict]) -> bool:
    """True when the cached witness concretely satisfies EVERY term —
    i.e. the set is SAT with this very assignment. False means the
    witness failed or could not be evaluated (never a verdict)."""
    if not model:
        return False
    env = model_env(model)
    memo: Dict = {}
    try:
        for t in raw_terms:
            if terms.evaluate(t, env, memo) is not True:
                return False
    except Exception:  # evaluation gap (exotic op, malformed model)
        return False
    return True


# ---------------------------------------------------------------------------
# UNSAT prefix-core minimization
# ---------------------------------------------------------------------------


def minimize_unsat_prefix(
    core,
    raw_terms: Sequence[Term],
    timeout_ms: int = CORE_PROBE_TIMEOUT_MS,
    max_probes: int = CORE_MAX_PROBES,
) -> Optional[Tuple[Term, ...]]:
    """The shortest UNSAT prefix of an already-UNSAT set, by bisection
    under assumptions on the (warm) incremental core.

    Prefix UNSAT-ness is monotone in the prefix length, so bisection is
    exact when every probe answers; an UNKNOWN probe (budget exhausted)
    is treated as SAT, which can only lengthen the reported prefix —
    still a correct UNSAT set, just less minimal. Returns None when the
    set cannot be lowered or the full-prefix sanity probe fails."""
    concrete = [t for t in raw_terms if t is not terms.TRUE]
    if not concrete:
        return None
    if any(t is terms.FALSE for t in concrete):
        idx = next(i for i, t in enumerate(concrete) if t is terms.FALSE)
        return tuple(concrete[: idx + 1])
    try:
        lowered: List[Tuple[int, Term]] = [core.lower(t) for t in concrete]
    except Exception:
        return None

    def probe(k: int) -> int:
        lits = [lw[0] for lw in lowered[:k]]
        rws = [lw[1] for lw in lowered[:k]]
        # boundary exception: solver_cache is this function's only
        # caller and hands over its own (warm) core — the probes refine
        # a verdict the boundary already recorded and accounted
        return core.solve_checked(lits, rws, timeout_ms=timeout_ms)  # noqa

    lo, hi = 1, len(concrete)
    probes = 0
    # sanity: the caller believes the full set is UNSAT; confirm once so
    # a stale belief can never mint a bogus subsumption seed
    if probe(hi) != pysat.UNSAT:
        return None
    while lo < hi and probes < max_probes:
        mid = (lo + hi) // 2
        probes += 1
        if probe(mid) == pysat.UNSAT:
            hi = mid
        else:
            lo = mid + 1
    return tuple(concrete[:hi])
