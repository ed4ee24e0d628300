"""Steady-state throughput meter — benchmark protocol v1 (BASELINE.md).

Why this exists: a plain ``total_states / wall`` quotient is dominated by
contract-creation amortization, so the measured rate swings ~2x with the
execution budget (round-4 artifacts reported 4.9x and 28.4x for the SAME
BECToken config at 120 s vs 90 s budgets).  The canonical protocol
instead measures one window per analysis run:

  open:  the start of the first message-call transaction round
         (LaserEVM ``start_sym_trans`` lifecycle hook) — creation is
         excluded from both the numerator and the denominator
  close: an explicit :meth:`close` after detection / witness solving
         (``fire_lasers``) so the post-pass cost both engines really pay
         stays inside the denominator

States counted are host ``total_states`` (the reference's unit:
mythril/laser/ethereum/svm.py:81) plus instructions retired on device by
the cuda-batch strategy, snapshotted at window open.
"""

import time
from typing import List, Tuple


def _device_steps(laser) -> int:
    """Device-retired instruction count from a CudaBatchStrategy
    (``device_steps_retired``) anywhere in the strategy decorator chain,
    without importing the backend module (attribute probe, same spirit
    as LaserEVM._has_tpu_strategy)."""
    strategy = laser.strategy
    seen = set()
    while strategy is not None and id(strategy) not in seen:
        seen.add(id(strategy))
        retired = getattr(strategy, "device_steps_retired", None)
        if retired is not None:
            return int(retired)
        strategy = getattr(strategy, "super_strategy", None)
    return 0


class SteadyStateMeter:
    """Accumulates steady-state (states, wall) windows across one or more
    analysis runs; rates aggregate as total states over total wall."""

    def __init__(self) -> None:
        self.windows: List[Tuple[int, float]] = []
        self._laser = None
        self._t0 = None
        self._states0 = 0

    # -- lifecycle -----------------------------------------------------------

    def install(self, laser) -> None:
        """Attach to a LaserEVM before sym_exec (fits SymExecWrapper's
        ``pre_exec_hook``). Closes any window left open on a previous
        laser so multi-contract rows aggregate cleanly."""
        self.close()
        self._laser = laser
        laser.register_laser_hooks("start_sym_trans", self._open)

    def _open(self) -> None:
        if self._t0 is None:
            self._t0 = time.time()
            self._states0 = self._count()

    def _count(self) -> int:
        return self._laser.total_states + _device_steps(self._laser)

    def close(self) -> None:
        """Close the current window (call after fire_lasers). Idempotent;
        a run that never reached a message-call round contributes no
        window (its creation-only work is out of protocol)."""
        if self._laser is not None and self._t0 is not None:
            self.windows.append(
                (self._count() - self._states0, time.time() - self._t0)
            )
        self._laser = None
        self._t0 = None

    # -- aggregates ----------------------------------------------------------

    @property
    def states(self) -> int:
        return sum(s for s, _ in self.windows)

    @property
    def wall(self) -> float:
        return sum(w for _, w in self.windows)

    @property
    def states_per_s(self) -> float:
        return self.states / max(self.wall, 1e-9)
