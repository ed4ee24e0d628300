"""SWC-113: several external calls inside one transaction.

Parity surface: mythril/analysis/module/modules/multiple_sends.py — call
sites accumulate on a state annotation; at transaction end (RETURN/STOP)
every call after the first is reported against its own offset."""

from copy import copy
from typing import List

from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import MULTIPLE_SENDS
from mythril_tpu_torch.laser.evm.state.annotation import StateAnnotation

CALL_OPS = ("CALL", "DELEGATECALL", "STATICCALL", "CALLCODE")


class CallSiteTrail(StateAnnotation):
    """Offsets of the call instructions executed on this path so far."""

    def __init__(self) -> None:
        self.offsets: List[int] = []

    def __copy__(self):
        clone = CallSiteTrail()
        clone.offsets = copy(self.offsets)
        return clone


def call_trail(state) -> "CallSiteTrail":
    for annotation in state.get_annotations(CallSiteTrail):
        return annotation
    annotation = CallSiteTrail()
    state.annotate(annotation)
    return annotation


class MultipleSends(ProbeModule):
    name = "Multiple external calls in the same transaction"
    swc_id = MULTIPLE_SENDS
    description = "Check for multiple sends in a single transaction"
    pre_hooks = list(CALL_OPS) + ["RETURN", "STOP"]

    title = "Multiple Calls in a Single Transaction"
    severity = "Low"
    description_head = "Multiple calls are executed in the same transaction."
    description_tail = (
        "This call is executed following another call within the same transaction. It is possible "
        "that the call never gets executed if a prior call fails permanently (this might be caused "
        "intentionally by a malicious callee). If possible, refactor the code such that each transaction "
        "only executes one external call."
    )
    first_match_only = True

    def probe(self, state):
        instruction = state.get_current_instruction()
        trail = call_trail(state)
        if instruction["opcode"] in CALL_OPS:
            trail.offsets.append(instruction["address"])
            return
        # transaction end: flag each call after the first
        for offset in trail.offsets[1:]:
            yield Finding(address=offset)


detector = MultipleSends()
