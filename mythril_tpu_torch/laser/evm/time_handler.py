"""Global execution-time budget.

Parity surface: mythril/laser/ethereum/time_handler.py — the analysis
solver couples its per-query budget to the time left in the run via
time_remaining()."""

import time

from mythril_tpu_torch.support.support_utils import Singleton

_UNLIMITED_MS = 100_000_000


def _now_ms() -> int:
    return int(time.time() * 1000)


class TimeHandler(object, metaclass=Singleton):
    def __init__(self):
        self._deadline_ms = None

    def start_execution(self, execution_time: int):
        self._deadline_ms = _now_ms() + execution_time * 1000

    def time_remaining(self) -> int:
        """Milliseconds left in the execution budget."""
        if self._deadline_ms is None:
            return _UNLIMITED_MS
        return self._deadline_ms - _now_ms()


time_handler = TimeHandler()
