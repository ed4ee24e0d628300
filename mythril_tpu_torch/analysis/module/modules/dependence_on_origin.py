"""SWC-115: control flow depends on tx.origin.

Parity surface: mythril/analysis/module/modules/dependence_on_origin.py —
the ORIGIN post-hook tags the pushed symbol; a JUMPI whose condition
carries the tag is an issue."""

from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import TX_ORIGIN_USAGE
from mythril_tpu_torch.smt import BitVec


class OriginTaint:
    """Expression annotation: value derives from ORIGIN."""


class TxOrigin(ProbeModule):
    name = "Control flow depends on tx.origin"
    swc_id = TX_ORIGIN_USAGE
    description = "Check whether control flow decisions are influenced by tx.origin"
    pre_hooks = ["JUMPI"]
    post_hooks = ["ORIGIN"]
    # the JUMPI probe only reads the condition's taint annotations, which
    # survive pack/lift; the bridge replays it at branch sites the device
    # retired. ORIGIN retires too: the post-hook taint replays over the
    # lifted leaf value (replay_tape_value below).
    tape_replay_hooks = frozenset({"JUMPI"})
    tape_replay_post_hooks = frozenset({"ORIGIN"})

    title = "Dependence on tx.origin"
    severity = "Low"
    description_head = "Use of tx.origin as a part of authorization control."
    description_tail = (
        "The tx.origin environment variable has been found to influence a control flow decision. "
        "Note that using tx.origin as a security control might cause a situation where a user "
        "inadvertently authorizes a smart contract to perform an action on their behalf. It is "
        "recommended to use msg.sender instead."
    )

    def probe(self, state):
        if state.get_current_instruction()["opcode"] != "JUMPI":
            # ORIGIN post-hook: taint the value just pushed
            state.mstate.stack[-1].annotate(OriginTaint())
            return
        condition = state.mstate.stack[-2]
        if any(isinstance(a, OriginTaint) for a in condition.annotations):
            yield Finding()

    def replay_tape_value(self, origin, opcode: str, value, arg):
        """Batch-aware ORIGIN post-hook: same taint, applied to a fresh
        wrapper so the shared seed term stays clean across lanes."""
        return BitVec(
            value.raw, annotations=set(value.annotations) | {OriginTaint()}
        )


detector = TxOrigin()
