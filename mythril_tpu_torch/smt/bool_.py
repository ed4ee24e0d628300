"""Boolean SMT expressions (reference surface: mythril/laser/smt/bool.py)."""

from typing import Set, Union

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.expression import Expression


class Bool(Expression):
    """A boolean expression."""

    @property
    def is_false(self) -> bool:
        return self.raw is terms.FALSE

    @property
    def is_true(self) -> bool:
        return self.raw is terms.TRUE

    @property
    def value(self) -> Union[bool, None]:
        if self.is_true:
            return True
        if self.is_false:
            return False
        return None

    def __eq__(self, other: object) -> "Bool":  # type: ignore
        if isinstance(other, Expression):
            return Bool(
                terms.bool_iff(self.raw, other.raw),
                self.annotations.union(other.annotations),
            )
        return Bool(terms.bool_iff(self.raw, terms.bool_const(bool(other))), set(self.annotations))

    def __ne__(self, other: object) -> "Bool":  # type: ignore
        eq = self.__eq__(other)
        return Bool(terms.bool_not(eq.raw), eq.annotations)

    def __bool__(self) -> bool:
        v = self.value
        return v if v is not None else False

    def __hash__(self) -> int:
        return hash(self.raw)


def _coerce(arg: Union[Bool, bool]) -> Bool:
    if isinstance(arg, Bool):
        return arg
    return Bool(terms.bool_const(bool(arg)))


def And(*args: Union[Bool, bool]) -> Bool:
    args_list = [_coerce(a) for a in args]
    annotations: Set = set()
    for arg in args_list:
        annotations = annotations.union(arg.annotations)
    return Bool(terms.bool_and(*[a.raw for a in args_list]), annotations)


def Or(*args: Union[Bool, bool]) -> Bool:
    args_list = [_coerce(a) for a in args]
    annotations: Set = set()
    for arg in args_list:
        annotations = annotations.union(arg.annotations)
    return Bool(terms.bool_or(*[a.raw for a in args_list]), annotations)


def Xor(a: Bool, b: Bool) -> Bool:
    union = a.annotations.union(b.annotations)
    return Bool(terms.bool_not(terms.bool_iff(a.raw, b.raw)), union)


def Not(a: Bool) -> Bool:
    return Bool(terms.bool_not(a.raw), set(a.annotations))


def is_false(a: Bool) -> bool:
    return a.raw is terms.FALSE


def is_true(a: Bool) -> bool:
    return a.raw is terms.TRUE
