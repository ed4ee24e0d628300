"""Fault tolerance for the analysis service and the TPU backend.

The multi-tenant service (service/) packs many jobs' frontiers into one
shared device batch and the solver layer (laser/tpu/solver_cache.py)
memoizes verdicts across rounds and resubmissions — so a single device
OOM, a hung host solve, or one malformed "poison" contract could take
down or silently corrupt every co-resident job. This package makes
every cross-seam failure mode injectable, survivable and observable:

  faults.py      deterministic, seeded fault-injection harness gated by
                 the ``MYTHRIL_TPU_FAULTS`` environment variable; fires
                 classified exceptions at the named seams
  retry.py       watchdog around each device round — bounded-backoff
                 retries, pack-size shrink on OOM, and a circuit breaker
                 that degrades the whole pipeline to host-only execution
  checkpoint.py  per-job frontier journal at transaction-round
                 boundaries so the scheduler can retry a FAILED job from
                 its last checkpoint instead of from scratch

See docs/ROBUSTNESS.md for seam names, the fault spec syntax, the
retry/degrade ladder and the quarantine semantics.
"""

from mythril_tpu_torch.robustness import faults
from mythril_tpu_torch.robustness.checkpoint import CheckpointJournal, FrontierCheckpoint
from mythril_tpu_torch.robustness.retry import (
    BREAKER,
    CircuitBreaker,
    DeviceRoundError,
    run_round_guarded,
)

__all__ = [
    "BREAKER",
    "CheckpointJournal",
    "CircuitBreaker",
    "DeviceRoundError",
    "FrontierCheckpoint",
    "faults",
    "run_round_guarded",
]
