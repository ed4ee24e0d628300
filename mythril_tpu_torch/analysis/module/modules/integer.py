"""SWC-101: integer overflow / underflow.

Parity surface: mythril/analysis/module/modules/integer.py. Three stages:

  1. ADD/SUB/MUL/EXP tag their result with an OverflowHazard carrying the
     precise wrap condition (BVAddNoOverflow-family constraints);
  2. sink hooks (SSTORE value, JUMPI condition, CALL value, RETURN data)
     collect hazards whose value influenced persistent state or control
     flow into a state annotation;
  3. at transaction end every collected hazard is solved together with
     the path condition; satisfiable wraps become issues reported at the
     arithmetic instruction (with per-origin sat/unsat caching so shared
     hazards are solved once).
"""

import logging
from copy import copy
from math import ceil, log2
from typing import Set

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.swc_data import INTEGER_OVERFLOW_AND_UNDERFLOW
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.evm.state.annotation import StateAnnotation
from mythril_tpu_torch.smt import (
    And,
    BVAddNoOverflow,
    BVMulNoOverflow,
    BVSubNoUnderflow,
    BitVec,
    Bool,
    Expression,
    If,
    Not,
    UGE,
    UGT,
    symbol_factory,
)

log = logging.getLogger(__name__)

WORD_BITS = 256


class OverflowHazard:
    """Expression annotation: the tagged value wraps iff `condition`."""

    __slots__ = ("origin_state", "operator", "condition")

    def __init__(self, origin_state, operator: str, condition: Bool) -> None:
        self.origin_state = origin_state
        self.operator = operator
        self.condition = condition

    def __deepcopy__(self, memodict=None):
        return copy(self)


class HazardsReachedSink(StateAnnotation):
    """State annotation: hazards whose value reached a sink on this path."""

    def __init__(self) -> None:
        self.hazards: Set[OverflowHazard] = set()

    def __copy__(self):
        clone = HazardsReachedSink()
        clone.hazards = copy(self.hazards)
        return clone


def _sink_annotation(state) -> HazardsReachedSink:
    for annotation in state.get_annotations(HazardsReachedSink):
        return annotation
    annotation = HazardsReachedSink()
    state.annotate(annotation)
    return annotation


def _as_bitvec(stack, index) -> BitVec:
    value = stack[index]
    if isinstance(value, BitVec):
        return value
    if isinstance(value, Bool):
        return If(value, 1, 0)
    stack[index] = symbol_factory.BitVecVal(value, 256)
    return stack[index]


def _collect(state, value) -> None:
    if not isinstance(value, Expression):
        return
    sink = _sink_annotation(state)
    for annotation in value.annotations:
        if isinstance(annotation, OverflowHazard):
            sink.hazards.add(annotation)


def _exp_wrap_condition(base: BitVec, exponent: BitVec):
    """When does base ** exponent exceed 2^256? (None = never)."""
    if base.symbolic and exponent.symbolic:
        return And(
            UGT(exponent, symbol_factory.BitVecVal(WORD_BITS, 256)),
            UGT(base, symbol_factory.BitVecVal(1, 256)),
        )
    if exponent.symbolic:
        if base.value < 2:
            return None
        threshold = ceil(WORD_BITS / log2(base.value))
        return UGE(exponent, symbol_factory.BitVecVal(threshold, 256))
    if base.symbolic:
        if exponent.value == 0:
            return None
        bits_per_unit = ceil(WORD_BITS / exponent.value)
        if bits_per_unit >= WORD_BITS:
            return None
        return UGE(base, symbol_factory.BitVecVal(2 ** bits_per_unit, 256))
    wraps = base.value >= 2 and exponent.value * log2(base.value) >= WORD_BITS
    return symbol_factory.Bool(bool(wraps))


class IntegerArithmetics(DetectionModule):
    name = "Integer overflow or underflow"
    swc_id = INTEGER_OVERFLOW_AND_UNDERFLOW
    description = (
        "For every SUB instruction, check if there's a possible state "
        "where op1 > op0. For every ADD, MUL instruction, check if "
        "there's a possible state where op1 + op0 > 2^256 - 1"
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = [
        "ADD",
        "MUL",
        "EXP",
        "SUB",
        "SSTORE",
        "JUMPI",
        "STOP",
        "RETURN",
        "CALL",
    ]
    # the arithmetic hooks only tag the operand value with a hazard; the
    # tag reconstructs exactly from a lifted tape node, so arithmetic can
    # retire on device (sinks and settlement stay host-hooked). Known
    # approximation: the device tape CSE-merges identical (op, operands)
    # nodes per lane, so arithmetic the host would tag at several sites
    # replays once, at the first site (compilers CSE such code anyway)
    tape_replay_hooks = frozenset({"ADD", "MUL", "EXP", "SUB", "JUMPI", "SSTORE"})

    def __init__(self) -> None:
        super().__init__()
        self._origin_sat: Set[object] = set()
        self._origin_unsat: Set[object] = set()

    def reset_module(self):
        super().reset_module()
        self._origin_sat = set()
        self._origin_unsat = set()

    # -- dispatch ----------------------------------------------------------

    def _execute(self, state) -> None:
        contract = state.environment.active_account.contract_name
        if (contract, state.get_current_instruction()["address"]) in self.cache:
            return
        opcode = state.get_current_instruction()["opcode"]
        stack = state.mstate.stack
        if opcode in ("ADD", "SUB", "MUL", "EXP"):
            self._tag_arithmetic(state, opcode)
        elif opcode == "SSTORE":
            _collect(state, stack[-2])
        elif opcode == "JUMPI":
            _collect(state, stack[-2])
        elif opcode == "CALL":
            _collect(state, stack[-3])
        elif opcode == "RETURN":
            self._collect_return_data(state)
            self._settle(state)
        else:  # STOP
            self._settle(state)

    # -- stage 1: hazard tagging -------------------------------------------

    def _tag_arithmetic(self, state, opcode: str) -> None:
        stack = state.mstate.stack
        self._tag_operands(state, opcode, _as_bitvec(stack, -1), _as_bitvec(stack, -2))

    def _tag_operands(self, origin, opcode: str, lhs, rhs) -> None:
        """Attach the wrap-hazard annotation; shared by the host hook and
        the tape replay (``origin`` is a GlobalState or a TapeOrigin)."""
        if opcode == "ADD":
            operator, wrap = "addition", Not(BVAddNoOverflow(lhs, rhs, False))
        elif opcode == "SUB":
            operator, wrap = "subtraction", Not(BVSubNoUnderflow(lhs, rhs, False))
        elif opcode == "MUL":
            operator, wrap = "multiplication", Not(BVMulNoOverflow(lhs, rhs, False))
        else:
            operator = "exponentiation"
            wrap = _exp_wrap_condition(lhs, rhs)
            if wrap is None:
                return
        lhs.annotate(OverflowHazard(origin, operator, wrap))

    def replay_tape_node(self, origin, opcode: str, lhs, rhs) -> None:
        """Batch-aware form of the arithmetic pre-hooks (see
        tape_replay_hooks): identical tagging over lifted operand terms.

        Accepted approximation: FULLY concrete arithmetic allocates no
        tape node on device (the result constant-folds), so a
        literal-operand overflow (e.g. PUSH max PUSH 1 ADD) that the
        host pre-hook would tag is not replayed. Solidity's optimizer
        folds such constants away before deployment, so real bytecode
        reaches this only through hand-written corner cases."""
        if lhs is None or rhs is None:
            return
        self._tag_operands(origin, opcode, lhs, rhs)

    def _collect_return_data(self, state) -> None:
        stack = state.mstate.stack
        offset, length = stack[-1], stack[-2]
        for cell in state.mstate.memory[offset : offset + length]:
            _collect(state, cell)

    # -- stage 3: transaction-end settlement --------------------------------

    def _settle(self, state) -> None:
        for hazard in _sink_annotation(state).hazards:
            origin = hazard.origin_state
            if origin in self._origin_unsat:
                continue
            if origin not in self._origin_sat and not self._wrap_feasible(hazard):
                continue
            try:
                witness = solver.get_transaction_sequence(
                    state, state.world_state.constraints + [hazard.condition]
                )
            except UnsatError:
                continue
            self._report(state, hazard, witness)

    # -- batched prescreen protocol (tpu-batch backend) ----------------------

    def batch_prescreen_requests(self, state, skip):
        """(cache token, constraints) pairs the backend may solve in one
        batched device feasibility call; verdicts come back through
        seed_prescreen. Covers exactly what _wrap_feasible would solve
        per hazard at settlement — origin-identity keyed, so a verdict
        seeded here makes the settlement solve a cache hit.

        ``skip`` (mutated here) dedups BEFORE the constraint lists are
        materialized: sibling lifted states share origins, and building
        BECToken-scale constraint copies per duplicate just for the
        caller to discard was the dominant collection cost."""
        # non-mutating lookup: this is a read path the backend calls on
        # every lifted state (including ones this module never touched —
        # e.g. when excluded via --modules); attaching an empty sink
        # annotation here would inflate every subsequent fork's copy
        sink = next(iter(state.get_annotations(HazardsReachedSink)), None)
        if sink is None:
            return []
        requests = []
        for hazard in sink.hazards:
            origin = hazard.origin_state
            if (
                origin in skip
                or origin in self._origin_sat
                or origin in self._origin_unsat
            ):
                continue
            skip.add(origin)
            requests.append(
                (
                    origin,
                    list(origin.world_state.constraints)
                    + [hazard.condition],
                )
            )
        return requests

    def seed_prescreen(self, token, verdict: bool) -> None:
        (self._origin_sat if verdict else self._origin_unsat).add(token)

    def _wrap_feasible(self, hazard) -> bool:
        """Solve the wrap condition at its origin once per origin state."""
        origin = hazard.origin_state
        try:
            solver.get_model(
                origin.world_state.constraints + [hazard.condition]
            )
            self._origin_sat.add(origin)
            return True
        except Exception:
            self._origin_unsat.add(origin)
            return False

    def _report(self, state, hazard, witness) -> None:
        origin = hazard.origin_state
        kind = "Underflow" if hazard.operator == "subtraction" else "Overflow"
        address = origin.get_current_instruction()["address"]
        self.cache.add(
            (origin.environment.active_account.contract_name, address)
        )
        self.issues.append(
            Issue(
                contract=origin.environment.active_account.contract_name,
                function_name=origin.environment.active_function_name,
                address=address,
                swc_id=INTEGER_OVERFLOW_AND_UNDERFLOW,
                bytecode=origin.environment.code.bytecode,
                title="Integer {}".format(kind),
                severity="High",
                description_head="The binary {} can {}.".format(
                    hazard.operator, kind.lower()
                ),
                description_tail=(
                    "It is possible to cause an integer {0} in the {1} operation. Prevent the {0} by constraining inputs "
                    "using the require() statement or use the OpenZeppelin SafeMath library for integer arithmetic operations. "
                    "Refer to the transaction trace generated for this issue to reproduce the {0}.".format(
                        kind.lower(), hazard.operator
                    )
                ),
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                transaction_sequence=witness,
            )
        )


detector = IntegerArithmetics()
