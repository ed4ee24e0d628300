"""Cross-cutting analysis parameters.

Parity surface: mythril/analysis/analysis_args.py — detection modules read
the loop bound and solver budget from one process-wide holder instead of
having them threaded through every constructor."""

from mythril_tpu_torch.support.support_utils import Singleton

_DEFAULT_LOOP_BOUND = 3
_DEFAULT_SOLVER_TIMEOUT_MS = 10_000


class AnalysisArgs(object, metaclass=Singleton):
    """Process-wide knobs shared by the analysis layer."""

    def __init__(self):
        self._params = {
            "loop_bound": _DEFAULT_LOOP_BOUND,
            "solver_timeout": _DEFAULT_SOLVER_TIMEOUT_MS,
        }

    def _set(self, key: str, value) -> None:
        if value is not None:
            self._params[key] = value

    def set_loop_bound(self, loop_bound):
        self._set("loop_bound", loop_bound)

    def set_solver_timeout(self, solver_timeout):
        self._set("solver_timeout", solver_timeout)

    @property
    def loop_bound(self):
        return self._params["loop_bound"]

    @property
    def solver_timeout(self):
        return self._params["solver_timeout"]


analysis_args = AnalysisArgs()
