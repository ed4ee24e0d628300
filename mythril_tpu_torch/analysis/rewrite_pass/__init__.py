"""Stage-3 static analysis: word-level constraint rewriting, interval
discharge, and assumption reuse ahead of the SAT kernel.

Public surface (consumed by laser/tpu/solver_cache.py and the bridge):

* ``enabled()`` — the ``MYTHRIL_TPU_REWRITE`` gate (default on; ``0``
  is the bench control arm).
* ``rewrite_set(raw_terms, seeds)`` — engine.RewriteOutcome: the
  canonicalized residual set, a static verdict when rewrite/intervals
  decided it, and the DAG-size deltas.
* ``try_witness`` / ``minimize_unsat_prefix`` — assumption-based
  incrementality (assume.py).
* ``note_unsat_term`` / ``any_known_unsat`` — the learned single-term
  prune facts the bridge consults alongside the jumpi_verdict
  plane.

See docs/REWRITE_PASS.md for the rule catalog and soundness arguments.
"""

import os

from mythril_tpu_torch.analysis.rewrite_pass.assume import (
    any_known_unsat,
    known_unsat_count,
    known_unsat_uid,
    minimize_unsat_prefix,
    note_unsat_term,
    reset_known_unsat,
    try_witness,
)
from mythril_tpu_torch.analysis.rewrite_pass.engine import (
    RewriteOutcome,
    reset_memo,
    rewrite_set,
    rewrite_term,
)
from mythril_tpu_torch.analysis.rewrite_pass.rules import RULES

__all__ = [
    "RULES",
    "RewriteOutcome",
    "any_known_unsat",
    "enabled",
    "known_unsat_count",
    "known_unsat_uid",
    "minimize_unsat_prefix",
    "note_unsat_term",
    "reset_for_tests",
    "reset_known_unsat",
    "reset_memo",
    "rewrite_set",
    "rewrite_term",
    "try_witness",
]


def enabled() -> bool:
    """The rewrite gate: MYTHRIL_TPU_REWRITE=0 disables the whole stage
    (the bench control arm: identical pipeline, raw constraint sets).
    Read per call so tests and the bench can flip it without reimport."""
    return os.environ.get("MYTHRIL_TPU_REWRITE", "1") != "0"


def reset_for_tests() -> None:
    reset_memo()
    reset_known_unsat()
