"""The path condition.

Parity surface: mythril/laser/ethereum/state/constraints.py — a list of
Bools with a memoized fast feasibility check. `is_possible` runs a
tightly budgeted solve through the incremental core (the frontier-wide
batched device solver seeds verdicts here via seed_feasibility, see
laser/tpu/backend.filter_feasible)."""

from typing import Iterable, List, Optional, Union

from mythril_tpu_torch.smt import Bool, Solver, simplify, symbol_factory, unsat

FEASIBILITY_BUDGET_MS = 100


def _lift(constraint: Union[bool, Bool]) -> Bool:
    return constraint if isinstance(constraint, Bool) else symbol_factory.Bool(constraint)


class Constraints(list):
    """The conjunction of branch conditions accumulated along one path."""

    def __init__(
        self,
        constraint_list: Optional[List[Bool]] = None,
        is_possible: Optional[bool] = None,
    ):
        super().__init__(_lift(c) for c in (constraint_list or []))
        self._is_possible = is_possible

    # -- feasibility ---------------------------------------------------------

    @property
    def is_possible(self) -> bool:
        """Quick-decidable satisfiability; `unknown` counts as possible.
        Memoized until the next append."""
        if self._is_possible is None:
            solver = Solver()
            solver.set_timeout(FEASIBILITY_BUDGET_MS)
            solver.add(*self)
            self._is_possible = solver.check() is not unsat
        return self._is_possible

    def seed_feasibility(self, value: bool) -> None:
        """Install an externally computed verdict (the batched device
        solver decides whole frontiers at once). Only sound results may
        be seeded."""
        self._is_possible = value

    # -- mutation ------------------------------------------------------------

    def append(self, constraint: Union[bool, Bool]) -> None:
        super().append(simplify(_lift(constraint)))
        self._is_possible = None

    def pop(self, index: int = -1) -> None:
        raise NotImplementedError

    def __iadd__(self, constraints: Iterable[Union[bool, Bool]]) -> "Constraints":
        super().__iadd__(_lift(c) for c in constraints)
        self._is_possible = None
        return self

    # -- non-mutating combinators ---------------------------------------------

    def __add__(self, constraints: Iterable[Union[bool, Bool]]) -> "Constraints":
        combined = super().__add__([_lift(c) for c in constraints])
        return Constraints(combined)

    @property
    def as_list(self) -> List[Bool]:
        return self[:]

    def __copy__(self) -> "Constraints":
        return Constraints(list(self), is_possible=self._is_possible)

    def __deepcopy__(self, memodict=None) -> "Constraints":
        return self.__copy__()

    def __hash__(self):
        return hash(tuple(self))
