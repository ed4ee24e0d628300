"""SMT array abstraction (reference surface: mythril/laser/smt/array.py).

Array / K wrap a store-chain term; reads through concrete store chains fold
away at construction time (terms.array_select), which is the hot path for
concrete calldata and storage.
"""

from typing import Union

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.bitvec import BitVec
from mythril_tpu_torch.smt.bitvec_helper import If
from mythril_tpu_torch.smt.bool_ import Bool


class BaseArray:
    """Base array type implementing select and store."""

    raw: terms.Term

    def __getitem__(self, item: BitVec) -> BitVec:
        if isinstance(item, slice):
            raise ValueError("BaseArray does not support getitem with slices")
        return BitVec(terms.array_select(self.raw, item.raw))

    def __setitem__(self, key: BitVec, value: Union[BitVec, Bool]) -> None:
        if isinstance(value, Bool):
            value = If(value, 1, 0)
        self.raw = terms.array_store(self.raw, key.raw, value.raw)


class Array(BaseArray):
    """A symbolic array (unconstrained mapping)."""

    def __init__(self, name: str, domain: int, value_range: int):
        self.domain = domain
        self.range = value_range
        self.raw = terms.array_var(name, domain, value_range)


class K(BaseArray):
    """An array initialized with a constant default value everywhere."""

    def __init__(self, domain: int, value_range: int, value: int):
        self.domain = domain
        self.range = value_range
        self.raw = terms.const_array(domain, value_range, value)
