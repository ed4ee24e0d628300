"""Partitioning solver (reference surface:
mythril/laser/smt/solver/independence_solver.py).

Splits the asserted constraints into buckets that share no symbols, solves
each bucket with its own SAT pipeline, and merges the per-bucket models.
This is also the seam the TPU batched solver uses: independent buckets are
exactly the units that can be solved as parallel lanes on device.
"""

from typing import Dict, List, Set

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.bool_ import Bool
from mythril_tpu_torch.smt.model import Model
from mythril_tpu_torch.smt.solver.solver import BaseSolver, CheckResult, Solver, sat, unknown, unsat
from mythril_tpu_torch.smt.solver.solver_statistics import stat_smt_query


def _get_expr_variables(expression: terms.Term) -> Set[str]:
    return set(terms.free_symbols(expression).keys())


class DependenceBucket:
    """Bucket of constraints that share variables."""

    def __init__(self, variables=None, conditions=None):
        self.variables: Set[str] = variables or set()
        self.conditions: List[terms.Term] = conditions or []


class DependenceMap:
    """Tracks the dependency-buckets of constraints."""

    def __init__(self):
        self.buckets: List[DependenceBucket] = []
        self.variable_map: Dict[str, DependenceBucket] = {}

    def add_condition(self, condition: terms.Term) -> None:
        variables = _get_expr_variables(condition)
        relevant: List[DependenceBucket] = []
        for var in variables:
            bucket = self.variable_map.get(var)
            if bucket is not None and bucket not in relevant:
                relevant.append(bucket)
        if not relevant:
            bucket = DependenceBucket(variables, [condition])
            self.buckets.append(bucket)
        else:
            bucket = self._merge_buckets(relevant)
            bucket.conditions.append(condition)
            bucket.variables |= variables
        for var in variables:
            self.variable_map[var] = bucket

    def _merge_buckets(self, bucket_list: List[DependenceBucket]) -> DependenceBucket:
        if len(bucket_list) == 1:
            return bucket_list[0]
        variables: Set[str] = set()
        conditions: List[terms.Term] = []
        for bucket in bucket_list:
            self.buckets.remove(bucket)
            variables |= bucket.variables
            conditions.extend(bucket.conditions)
        new_bucket = DependenceBucket(variables, conditions)
        self.buckets.append(new_bucket)
        for var in variables:
            self.variable_map[var] = new_bucket
        return new_bucket


class IndependenceSolver(BaseSolver):
    """Solves constraint buckets independently and merges the models."""

    def __init__(self):
        super().__init__()
        self.models: List = []

    @stat_smt_query
    def check(self, *extra_constraints) -> CheckResult:
        dependence_map = DependenceMap()
        extras: List[Bool] = []
        for c in extra_constraints:
            if isinstance(c, (list, tuple)):
                extras.extend(c)
            else:
                extras.append(c)
        for constraint in self.constraints + extras:
            if constraint.raw is terms.FALSE:
                return unsat
            if constraint.raw is terms.TRUE:
                continue
            dependence_map.add_condition(constraint.raw)

        self.models = []
        for bucket in dependence_map.buckets:
            solver = Solver()
            solver.set_timeout(self.timeout or 0)
            solver.conflict_budget = self.conflict_budget
            solver.add(*[Bool(c) for c in bucket.conditions])
            result = solver.check()
            if result is unsat:
                return unsat
            if result is unknown:
                return unknown
            env = solver._model_env
            if env is not None:
                self.models.append(env)
        return sat

    def model(self) -> Model:
        return Model(self.models)
