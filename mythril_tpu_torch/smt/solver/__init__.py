from mythril_tpu_torch.smt.solver.solver import (
    BaseSolver,
    CheckResult,
    Optimize,
    Solver,
    sat,
    unknown,
    unsat,
)
from mythril_tpu_torch.smt.solver.independence_solver import IndependenceSolver
from mythril_tpu_torch.smt.solver.solver_statistics import SolverStatistics
