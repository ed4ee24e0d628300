"""SWC-104: external call return value never constrained.

Parity surface: mythril/analysis/module/modules/unchecked_retval.py — the
post-hook of each call family instruction records the pushed return-value
symbol; at transaction end, any recorded retval that can still be 0 on
this path was never checked."""

from copy import copy
from typing import List, Tuple

from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import UNCHECKED_RET_VAL
from mythril_tpu_torch.laser.evm.state.annotation import StateAnnotation

CALL_OPS = ("CALL", "DELEGATECALL", "STATICCALL", "CALLCODE")


class RetvalTrail(StateAnnotation):
    """(call site, return-value symbol) pairs seen on this path."""

    def __init__(self) -> None:
        self.retvals: List[Tuple[int, object]] = []

    def __copy__(self):
        clone = RetvalTrail()
        clone.retvals = copy(self.retvals)
        return clone


def retval_trail(state) -> "RetvalTrail":
    for annotation in state.get_annotations(RetvalTrail):
        return annotation
    annotation = RetvalTrail()
    state.annotate(annotation)
    return annotation


class UncheckedRetval(ProbeModule):
    name = "Return value of an external call is not checked"
    swc_id = UNCHECKED_RET_VAL
    description = (
        "Test whether CALL return value is checked. "
        "For direct calls, the Solidity compiler auto-generates this check; "
        "for low-level calls it is omitted."
    )
    pre_hooks = ["STOP", "RETURN"]
    post_hooks = list(CALL_OPS)

    title = "Unchecked return value from external call."
    severity = "Low"
    description_head = "The return value of a message call is not checked."
    description_tail = (
        "External calls return a boolean value. If the callee halts with an exception, 'false' is "
        "returned and execution continues in the caller. It is often desirable to wrap external calls "
        "into a require() statement so the transaction is reverted if the call fails. Make sure that "
        "no unexpected behaviour occurs if the call is unsuccessful."
    )

    def site_address(self, state):
        # dedup is per reported retval site, handled in probe()
        return -1

    def probe(self, state):
        instruction = state.get_current_instruction()
        trail = retval_trail(state)
        if instruction["opcode"] in ("STOP", "RETURN"):
            contract = state.environment.active_account.contract_name
            for site, retval in trail.retvals:
                if (contract, site) in self.cache:
                    continue
                yield Finding(address=site, constraints=[retval == 0])
            return
        # call post-hook: pc already advanced past the call instruction
        previous = state.environment.code.instruction_list[state.mstate.pc - 1]
        if previous["opcode"] not in CALL_OPS:
            return
        trail.retvals.append(
            (state.instruction["address"] - 1, state.mstate.stack[-1])
        )


detector = UncheckedRetval()
