"""SWC-106: SELFDESTRUCT reachable by an arbitrary sender.

Parity surface: mythril/analysis/module/modules/suicide.py — every
message-call sender in the sequence is pinned to the attacker; the
stronger variant (beneficiary == attacker) is tried before the plain
reachability variant, and only one issue is reported per site."""

from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import UNPROTECTED_SELFDESTRUCT
from mythril_tpu_torch.laser.evm.transaction.symbolic import ACTORS
from mythril_tpu_torch.laser.evm.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.smt import And

_TAIL_WITH_BALANCE = (
    "Any sender can trigger execution of the SELFDESTRUCT instruction to destroy this "
    "contract account and withdraw its balance to an arbitrary address. Review the transaction trace "
    "generated for this issue and make sure that appropriate security controls are in place to prevent "
    "unrestricted access."
)
_TAIL_PLAIN = (
    "Any sender can trigger execution of the SELFDESTRUCT instruction to destroy this "
    "contract account. Review the transaction trace generated for this issue and make sure that "
    "appropriate security controls are in place to prevent unrestricted access."
)


def attacker_is_every_sender(state):
    """One conjunct per message call: caller == attacker == origin."""
    pins = []
    for tx in state.world_state.transaction_sequence:
        if isinstance(tx, ContractCreationTransaction):
            continue
        pins.append(And(tx.caller == ACTORS.attacker, tx.caller == tx.origin))
    return pins


class AccidentallyKillable(ProbeModule):
    name = "Contract can be accidentally killed by anyone"
    swc_id = UNPROTECTED_SELFDESTRUCT
    description = (
        "Check if the contract can be killed by anyone; for kill-able "
        "contracts, also check whether the balance can be sent to the attacker."
    )
    pre_hooks = ["SUICIDE"]

    title = "Unprotected Selfdestruct"
    severity = "High"
    description_head = "Any sender can cause the contract to self-destruct."
    first_match_only = True

    def probe(self, state):
        beneficiary = state.mstate.stack[-1]
        pins = attacker_is_every_sender(state)
        yield Finding(
            constraints=pins + [beneficiary == ACTORS.attacker],
            description_tail=_TAIL_WITH_BALANCE,
        )
        yield Finding(constraints=pins, description_tail=_TAIL_PLAIN)


detector = AccidentallyKillable()
