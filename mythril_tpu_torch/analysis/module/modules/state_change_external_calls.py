"""SWC-107: persistent state accessed after an external call (reentrancy
window).

Parity surface:
mythril/analysis/module/modules/state_change_external_calls.py — each
gas-forwarding call annotates the path with an open reentrancy window;
any later storage access (or value transfer) inside a window defers a
potential issue whose constraints re-pin the original call's operands."""

import logging
from copy import copy
from typing import List, Optional

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import REENTRANCY
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.evm.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.evm.state.constraints import Constraints
from mythril_tpu_torch.smt import UGT, Or, symbol_factory

log = logging.getLogger(__name__)

CALL_OPS = ("CALL", "DELEGATECALL", "CALLCODE")
STATE_ACCESS_OPS = ("SSTORE", "SLOAD", "CREATE", "CREATE2")
from mythril_tpu_torch.support.opcodes import GSTIPEND as GAS_STIPEND
ATTACKER_PROBE_ADDRESS = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF


class ReentrancyWindow(StateAnnotation):
    """Open from a gas-forwarding external call until transaction end."""

    # the window must observe every SSTORE/SLOAD/CREATE that follows the
    # call; states carrying one stay on the host path (PackError)
    pack_to_device = False

    def __init__(self, call_state, attacker_controlled: bool) -> None:
        self.call_state = call_state
        self.attacker_controlled = attacker_controlled
        self.accesses: List[object] = []

    def __copy__(self):
        clone = ReentrancyWindow(self.call_state, self.attacker_controlled)
        clone.accesses = self.accesses[:]
        return clone

    def call_constraints(self) -> Constraints:
        """Re-pin the original call: gas beyond the stipend, callee not a
        precompile (or zero), and — when established at the call site —
        attacker-chosen."""
        gas = self.call_state.mstate.stack[-1]
        callee = self.call_state.mstate.stack[-2]
        constraints = Constraints(
            [
                UGT(gas, symbol_factory.BitVecVal(GAS_STIPEND, 256)),
                Or(
                    UGT(callee, symbol_factory.BitVecVal(16, 256)),
                    callee == symbol_factory.BitVecVal(0, 256),
                ),
            ]
        )
        if self.attacker_controlled:
            constraints += [callee == ATTACKER_PROBE_ADDRESS]
        return constraints


class StateChangeAfterCall(ProbeModule):
    name = "State change after an external call"
    swc_id = REENTRANCY
    description = (
        "Check whether the account state is accessed after the execution "
        "of an external call"
    )
    pre_hooks = list(CALL_OPS) + list(STATE_ACCESS_OPS)
    # safe to retire on device: without an open ReentrancyWindow the
    # SSTORE/SLOAD probe is vacuous, and window-carrying states never
    # pack (ReentrancyWindow.pack_to_device); CALL/CREATE always trap
    tape_replay_hooks = frozenset({"SSTORE", "SLOAD"})

    deferred = True
    severity = "Low"
    title = "State access after external call"

    def probe(self, state):
        opcode = state.get_current_instruction()["opcode"]
        windows = list(state.get_annotations(ReentrancyWindow))

        if opcode in STATE_ACCESS_OPS:
            for window in windows:
                window.accesses.append(state)
        elif opcode in CALL_OPS:
            # a nonzero value transfer is itself a balance state change
            if self._value_can_flow(state):
                for window in windows:
                    window.accesses.append(state)
            self._open_window(state)

        for window in windows:
            if not window.accesses:
                continue
            finding = self._window_finding(state, window, opcode)
            if finding is not None:
                yield finding

    # -- window bookkeeping ------------------------------------------------

    @staticmethod
    def _value_can_flow(state) -> bool:
        value = state.mstate.stack[-3]
        if not value.symbolic:
            return value.value > 0
        try:
            solver.get_model(
                copy(state.world_state.constraints)
                + [UGT(value, symbol_factory.BitVecVal(0, 256))]
            )
            return True
        except UnsatError:
            return False

    @staticmethod
    def _open_window(state) -> None:
        gas = state.mstate.stack[-1]
        callee = state.mstate.stack[-2]
        base = copy(state.world_state.constraints)
        try:
            solver.get_model(
                base
                + [
                    UGT(gas, symbol_factory.BitVecVal(GAS_STIPEND, 256)),
                    Or(
                        UGT(callee, symbol_factory.BitVecVal(16, 256)),
                        callee == symbol_factory.BitVecVal(0, 256),
                    ),
                ]
            )
        except UnsatError:
            return
        try:
            solver.get_model(base + [callee == ATTACKER_PROBE_ADDRESS])
            state.annotate(ReentrancyWindow(state, True))
        except UnsatError:
            state.annotate(ReentrancyWindow(state, False))

    # -- issue assembly ----------------------------------------------------

    def _window_finding(self, state, window, opcode) -> Optional[Finding]:
        access_kind = "Read of" if opcode == "SLOAD" else "Write to"
        address_kind = "user defined" if window.attacker_controlled else "fixed"
        return Finding(
            constraints=list(window.call_constraints()),
            severity="Medium" if window.attacker_controlled else "Low",
            description_head="{} persistent state following external call".format(
                access_kind
            ),
            description_tail=(
                "The contract account state is accessed after an external call to a {} address. Note that the callee "
                "could re-enter any function in this contract before the state access has occurred. Review the contract "
                "logic carefully and consider performing all state operations before executing the external call, "
                "especially if the callee is not trusted.".format(address_kind)
            ),
        )


detector = StateChangeAfterCall()
