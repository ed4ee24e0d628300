"""Uninterpreted functions (reference surface: mythril/laser/smt/function.py).

Used by the keccak function manager to model hash functions as UF pairs with
consistency axioms; the solver eliminates applications by Ackermannization.
"""

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.bitvec import BitVec


class Function:
    """An uninterpreted function from one bitvector sort to another."""

    def __init__(self, name: str, domain: int, value_range: int):
        self.name = name
        self.domain = domain
        self.range = value_range

    def __call__(self, item: BitVec) -> BitVec:
        raw = terms.func_app(self.name, (item.raw,), (self.domain,), self.range)
        return BitVec(raw, annotations=set(item.annotations))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Function)
            and self.name == other.name
            and self.domain == other.domain
            and self.range == other.range
        )

    def __hash__(self) -> int:
        return hash((self.name, self.domain, self.range))
