"""The SMT abstraction layer (reference surface: mythril/laser/smt/__init__.py).

Same public API as the reference — symbol_factory, BitVec/Bool/Array/K/
Function, helper ops, Solver/Optimize/Model — but backed by the in-repo term
DAG and solver pipeline instead of z3.
"""

from typing import Any, Generic, Optional, Set, TypeVar, Union

from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.bitvec import BitVec
from mythril_tpu_torch.smt.bitvec_helper import (
    BVAddNoOverflow,
    BVMulNoOverflow,
    BVSubNoUnderflow,
    Concat,
    Extract,
    If,
    LShR,
    SignExt,
    Sum,
    UDiv,
    UGE,
    UGT,
    ULE,
    ULT,
    URem,
    SRem,
    ZeroExt,
)
from mythril_tpu_torch.smt.expression import Expression, simplify
from mythril_tpu_torch.smt.bool_ import And, Bool, Not, Or, Xor, is_false, is_true
from mythril_tpu_torch.smt.bool_ import Bool as SMTBool
from mythril_tpu_torch.smt.array import Array, BaseArray, K
from mythril_tpu_torch.smt.function import Function
from mythril_tpu_torch.smt.model import Model
from mythril_tpu_torch.smt.solver import (
    BaseSolver,
    IndependenceSolver,
    Optimize,
    Solver,
    SolverStatistics,
    sat,
    unknown,
    unsat,
)

Annotations = Optional[Set[Any]]
T = TypeVar("T", bound=Bool)
U = TypeVar("U", bound=BitVec)


class SymbolFactory(Generic[T, U]):
    """A symbol factory provides a default interface for all the components
    of the framework to create symbols."""

    @staticmethod
    def Bool(value: bool, annotations: Annotations = None) -> T:
        raise NotImplementedError

    @staticmethod
    def BoolSym(name: str, annotations: Annotations = None) -> T:
        raise NotImplementedError

    @staticmethod
    def BitVecVal(value: int, size: int, annotations: Annotations = None) -> U:
        raise NotImplementedError

    @staticmethod
    def BitVecSym(name: str, size: int, annotations: Annotations = None) -> U:
        raise NotImplementedError


class _SmtSymbolFactory(SymbolFactory[Bool, BitVec]):
    """Creates symbols using the wrapper classes in mythril_tpu_torch.smt."""

    @staticmethod
    def Bool(value: bool, annotations: Annotations = None) -> Bool:
        return SMTBool(terms.bool_const(value), annotations)

    @staticmethod
    def BoolSym(name: str, annotations: Annotations = None) -> Bool:
        return SMTBool(terms.bool_var(name), annotations)

    @staticmethod
    def BitVecVal(value: int, size: int, annotations: Annotations = None) -> BitVec:
        return BitVec(terms.bv_const(value, size), annotations)

    @staticmethod
    def BitVecSym(name: str, size: int, annotations: Annotations = None) -> BitVec:
        return BitVec(terms.bv_var(name, size), annotations)


# The instance all other components use to mint symbols.
symbol_factory = _SmtSymbolFactory()
