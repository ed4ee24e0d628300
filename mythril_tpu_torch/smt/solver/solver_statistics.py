"""Solver query accounting.

Parity surface: mythril/laser/smt/solver/solver_statistics.py — a
process-wide counter/timer around every solver check, switched on by the
analyzer and printed per contract."""

from time import time

from mythril_tpu_torch.support.support_utils import Singleton


class SolverStatistics(object, metaclass=Singleton):
    """Enabled -> counts queries and accumulates wall time."""

    def __init__(self):
        self.enabled = False
        self.query_count = 0
        self.solver_time = 0.0

    def add_query_time(self, elapsed: float) -> None:
        self.query_count += 1
        self.solver_time += elapsed

    def __repr__(self):
        return "Query count: {} \nSolver time: {}".format(
            self.query_count, self.solver_time
        )


def stat_smt_query(func):
    """Wrap a solver check with the global statistics collector."""

    stats = SolverStatistics()

    def timed(*args, **kwargs):
        if not stats.enabled:
            return func(*args, **kwargs)
        started = time()
        try:
            return func(*args, **kwargs)
        finally:
            stats.add_query_time(time() - started)

    return timed
