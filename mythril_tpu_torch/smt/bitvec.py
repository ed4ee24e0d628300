"""Bitvector SMT expressions (reference surface: mythril/laser/smt/bitvec.py).

Operator conventions follow the z3 python bindings the reference relies on:
`<, >, <=, >=, /` are SIGNED; `>>` is an ARITHMETIC shift. The unsigned
variants live in bitvec_helper (ULT, UDiv, LShR, ...). Mixed-width equality
zero-pads the narrower operand (needed for the 512-bit sha3 input terms,
see reference bitvec.py:16).
"""

from typing import Optional, Set, Union

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.bool_ import Bool
from mythril_tpu_torch.smt.expression import Expression

Annotations = Set


class BitVec(Expression):
    """A bitvector expression."""

    def __init__(self, raw: terms.Term, annotations: Optional[Annotations] = None):
        super().__init__(raw, annotations)

    def size(self) -> int:
        return self.raw.size

    @property
    def symbolic(self) -> bool:
        """Whether this symbol doesn't have a concrete value."""
        return not self.raw.is_const

    @property
    def value(self) -> Optional[int]:
        """The concrete value, or None when symbolic."""
        return self.raw.value

    def _coerce(self, other: Union[int, "BitVec"]) -> "BitVec":
        if isinstance(other, BitVec):
            return other
        return BitVec(terms.bv_const(int(other), self.size()))

    def _bin(self, other: Union[int, "BitVec"], fn) -> "BitVec":
        other = self._coerce(other)
        union = self.annotations.union(other.annotations)
        return BitVec(fn(self.raw, other.raw), union)

    def _cmp(self, other: Union[int, "BitVec"], fn) -> Bool:
        other = self._coerce(other)
        union = self.annotations.union(other.annotations)
        return Bool(fn(self.raw, other.raw), union)

    def __add__(self, other):
        return self._bin(other, terms.bv_add)

    def __radd__(self, other):
        return self._bin(other, lambda a, b: terms.bv_add(b, a))

    def __sub__(self, other):
        return self._bin(other, terms.bv_sub)

    def __rsub__(self, other):
        return self._bin(other, lambda a, b: terms.bv_sub(b, a))

    def __mul__(self, other):
        return self._bin(other, terms.bv_mul)

    def __rmul__(self, other):
        return self._bin(other, lambda a, b: terms.bv_mul(b, a))

    def __truediv__(self, other):
        # signed division, matching z3's BitVecRef.__div__
        return self._bin(other, terms.bv_sdiv)

    def __and__(self, other):
        return self._bin(other, terms.bv_and)

    def __rand__(self, other):
        return self._bin(other, terms.bv_and)

    def __or__(self, other):
        return self._bin(other, terms.bv_or)

    def __xor__(self, other):
        return self._bin(other, terms.bv_xor)

    def __invert__(self):
        return BitVec(terms.bv_not(self.raw), set(self.annotations))

    def __neg__(self):
        return BitVec(terms.bv_neg(self.raw), set(self.annotations))

    def __lshift__(self, other):
        return self._bin(other, terms.bv_shl)

    def __rshift__(self, other):
        # arithmetic shift, matching z3's BitVecRef.__rshift__
        return self._bin(other, terms.bv_ashr)

    def __lt__(self, other) -> Bool:
        return self._cmp(other, terms.bool_slt)

    def __gt__(self, other) -> Bool:
        return self._cmp(other, lambda a, b: terms.bool_slt(b, a))

    def __le__(self, other) -> Bool:
        return self._cmp(other, terms.bool_sle)

    def __ge__(self, other) -> Bool:
        return self._cmp(other, lambda a, b: terms.bool_sle(b, a))

    def __eq__(self, other) -> Bool:  # type: ignore
        if not isinstance(other, BitVec):
            if isinstance(other, (int, bool)):
                other = self._coerce(int(other))
            else:
                return Bool(terms.FALSE, set(self.annotations))
        union = self.annotations.union(other.annotations)
        return Bool(terms.bool_eq(self.raw, other.raw), union)

    def __ne__(self, other) -> Bool:  # type: ignore
        if not isinstance(other, BitVec):
            if isinstance(other, (int, bool)):
                other = self._coerce(int(other))
            else:
                return Bool(terms.TRUE, set(self.annotations))
        union = self.annotations.union(other.annotations)
        return Bool(terms.bool_ne(self.raw, other.raw), union)

    def __hash__(self) -> int:
        return hash(self.raw)

    def as_long(self) -> int:
        v = self.raw.value
        if v is None:
            raise ValueError("as_long() on symbolic bitvector")
        return v
