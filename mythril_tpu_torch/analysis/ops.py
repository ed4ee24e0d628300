"""Statespace operation records for POST-style analysis.

Parity surface: mythril/analysis/ops.py — lightweight records of CALL /
SSTORE operations extracted from the explored statespace, each value
wrapped with its concreteness."""

from enum import Enum

from mythril_tpu_torch.laser.evm import util
from mythril_tpu_torch.smt import simplify


class VarType(Enum):
    SYMBOLIC = 1
    CONCRETE = 2


class Variable:
    """A value plus whether it is concrete or symbolic."""

    __slots__ = ("val", "type")

    def __init__(self, val, _type):
        self.val = val
        self.type = _type

    def __str__(self):
        return str(self.val)


def get_variable(value) -> Variable:
    """Concretize if possible, else keep the simplified symbolic form."""
    try:
        return Variable(util.get_concrete_int(value), VarType.CONCRETE)
    except TypeError:
        return Variable(simplify(value), VarType.SYMBOLIC)


class Op:
    """An operation anchored at (node, state, index) in the statespace."""

    __slots__ = ("node", "state", "state_index")

    def __init__(self, node, state, state_index):
        self.node = node
        self.state = state
        self.state_index = state_index


class Call(Op):
    __slots__ = ("to", "gas", "type", "value", "data")

    def __init__(self, node, state, state_index, _type, to, gas, value=None, data=None):
        super().__init__(node, state, state_index)
        self.to = to
        self.gas = gas
        self.type = _type
        self.value = value if value is not None else Variable(0, VarType.CONCRETE)
        self.data = data


class SStore(Op):
    __slots__ = ("value",)

    def __init__(self, node, state, state_index, value):
        super().__init__(node, state, state_index)
        self.value = value
