"""Per-job frontier checkpoints at transaction-round boundaries.

The natural serialization boundary of a multi-transaction analysis is
the open_states handoff between message-call rounds (the same boundary
support/checkpoint.py uses for on-disk checkpoints). The service keeps
its checkpoints IN MEMORY instead: every K completed rounds the journal
snapshots the job's host-side frontier (a pickle through the term DAG's
re-interning ``__reduce__``, so later rounds cannot mutate the
snapshot), and when a job FAILs the scheduler retries it once from the
latest snapshot via ``SymExecWrapper(resume_from=...)`` instead of from
scratch.

K defaults to 1 (every round) and is tuned with
``MYTHRIL_TPU_CKPT_EVERY``; ``0`` disables journaling. Snapshot cost is
accounted in ``overhead_s`` and surfaces as ``checkpoint_overhead_s``
in ``bench.py --service``.
"""

import logging
import os
import pickle
import threading
import time
from typing import Dict, Optional

from mythril_tpu_torch import obs
from mythril_tpu_torch.obs import catalog as _cat

log = logging.getLogger(__name__)

ENV_EVERY = "MYTHRIL_TPU_CKPT_EVERY"
DEFAULT_EVERY = 1

# job_id -> owning journal, registered by install() and dropped by
# clear(): the route for device-round CREDITS from the backend's fused
# super-rounds (see credit_rounds). Module-level because exec_batch
# only knows the job id, not which service's journal owns it.
_CREDIT_SINKS: Dict[str, "CheckpointJournal"] = {}
_SINKS_LOCK = threading.Lock()


def credit_rounds(job_id: str, k: int) -> None:
    """Credit ``k`` retired device rounds to ``job_id``'s journal.

    A K-fused super-round retires K device rounds inside one guarded
    call; without credits the journal — whose cadence counts journal-
    hook firings — would silently stretch its interval by K. Once a
    job's credits cover one cadence period, the next ``stop_sym_trans``
    snapshots regardless of the modulus. No-op for jobs without an
    installed journal (single-tenant CLI runs)."""
    with _SINKS_LOCK:
        journal = _CREDIT_SINKS.get(job_id)
    if journal is not None:
        journal._credit(job_id, k)


class FrontierCheckpoint:
    """One journaled frontier: the open-state set after ``rounds_done``
    completed message-call rounds of job ``job_id`` against ``address``.

    The frontier is held pickled so the live states a round keeps
    mutating can never reach back into the snapshot."""

    __slots__ = ("job_id", "rounds_done", "address", "_payload", "n_states")

    def __init__(self, job_id: str, rounds_done: int, address: int, open_states):
        self.job_id = job_id
        self.rounds_done = rounds_done
        self.address = address
        self.n_states = len(open_states)
        self._payload = pickle.dumps(open_states, protocol=pickle.HIGHEST_PROTOCOL)

    def restore(self):
        """-> a fresh open-state list, independent of any live objects."""
        return pickle.loads(self._payload)

    def __repr__(self):
        return "<FrontierCheckpoint job=%s rounds_done=%d states=%d>" % (
            self.job_id, self.rounds_done, self.n_states,
        )


class CheckpointJournal:
    """In-memory latest-frontier journal, one slot per job.

    ``install`` hooks a job's LaserEVM; the hook fires at every
    ``stop_sym_trans`` (end of one message-call round) and overwrites
    the job's slot every K rounds. Only the LATEST checkpoint is kept —
    a retry wants the furthest frontier, and holding every round's
    frontier for every resident job would defeat the memory ceiling the
    lane packing exists for."""

    def __init__(self, every: Optional[int] = None):
        if every is None:
            try:
                every = int(os.environ.get(ENV_EVERY, DEFAULT_EVERY))
            except ValueError:
                log.warning("bad %s=%r, using %d", ENV_EVERY,
                            os.environ.get(ENV_EVERY), DEFAULT_EVERY)
                every = DEFAULT_EVERY
        self.every = every
        self._lock = threading.Lock()
        self._latest: Dict[str, FrontierCheckpoint] = {}
        self._credits: Dict[str, int] = {}
        self.overhead_s = 0.0
        self.snapshots = 0

    def _credit(self, job_id: str, k: int) -> None:
        with self._lock:
            self._credits[job_id] = self._credits.get(job_id, 0) + max(
                0, int(k)
            )

    def install(self, job_id: str, laser, total_rounds: int,
                rounds_offset: int = 0) -> None:
        """Register the journaling hook on ``laser`` for this attempt.

        ``rounds_offset`` is the number of rounds already completed
        before this attempt (a resumed job keeps counting from its
        checkpoint, so round numbers in error reports stay absolute).
        The last round's frontier is not journaled: the job is done,
        and a failure after it has nothing left to resume."""
        if self.every <= 0:
            return
        with _SINKS_LOCK:
            _CREDIT_SINKS[job_id] = self
        state = {"completed": rounds_offset}

        def journal_hook():
            state["completed"] += 1
            done = state["completed"]
            if done >= total_rounds:
                return
            with self._lock:
                credits = self._credits.get(job_id, 0)
            # cadence: the round modulus, OR enough device-round credits
            # (fused super-rounds, credit_rounds) to cover one period —
            # a K=32 fused round must not skip K-1 intervals silently
            if (done - rounds_offset) % self.every and credits < self.every:
                return
            address = getattr(laser, "executed_transaction_address", None)
            if address is None:
                return
            t0 = time.time()
            try:
                ckpt = FrontierCheckpoint(
                    job_id, done, int(address), laser.open_states
                )
            except Exception as e:
                # best-effort: an unpicklable annotation costs the
                # checkpoint, never the round
                log.warning("checkpoint snapshot failed for job %s "
                            "(round %d): %s", job_id, done, e)
                return
            dt = time.time() - t0
            with self._lock:
                self._latest[job_id] = ckpt
                self.snapshots += 1
                self.overhead_s += dt
                self._credits[job_id] = 0
            _cat.CHECKPOINTS_TOTAL.inc()
            _cat.CHECKPOINT_OVERHEAD_S.inc(dt)
            obs.TRACER.mark(
                "checkpoint", job=job_id, round=done, states=ckpt.n_states,
            )
            log.debug("journaled %s", ckpt)

        laser.register_laser_hooks("stop_sym_trans", journal_hook)

    def latest(self, job_id: str) -> Optional[FrontierCheckpoint]:
        with self._lock:
            return self._latest.get(job_id)

    def clear(self, job_id: str) -> None:
        with _SINKS_LOCK:
            if _CREDIT_SINKS.get(job_id) is self:
                _CREDIT_SINKS.pop(job_id, None)
        with self._lock:
            self._latest.pop(job_id, None)
            self._credits.pop(job_id, None)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "jobs_journaled": len(self._latest),
                "snapshots": self.snapshots,
                "overhead_s": self.overhead_s,
            }
