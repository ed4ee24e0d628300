"""SWC-127: jump to a caller-controlled location.

Parity surface: mythril/analysis/module/modules/arbitrary_jump.py — an
issue fires when a JUMP/JUMPI destination is symbolic (and the path is
satisfiable, which the probe runner checks by solving the sequence)."""

from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import ARBITRARY_JUMP


class ArbitraryJump(ProbeModule):
    name = "Caller can redirect execution to arbitrary bytecode locations"
    swc_id = ARBITRARY_JUMP
    description = "Search for jumps to arbitrary locations in the bytecode"
    pre_hooks = ["JUMP", "JUMPI"]
    # a symbolic jump destination traps the lane (frozen BEFORE the jump,
    # so the host re-executes it with hooks); device-retired jumps are
    # concrete-dest by construction and can never fire this probe
    tape_replay_hooks = frozenset({"JUMP", "JUMPI"})

    title = "Jump to an arbitrary instruction"
    severity = "High"
    description_head = "The caller can redirect execution to arbitrary bytecode locations."
    description_tail = (
        "It is possible to redirect the control flow to arbitrary locations in the code. "
        "This may allow an attacker to bypass security controls or manipulate the business logic of the "
        "smart contract. Avoid using low-level-operations and assembly to prevent this issue."
    )

    def probe(self, state):
        destination = state.mstate.stack[-1]
        if destination.symbolic:
            yield Finding()


detector = ArbitraryJump()
