"""SWC-105: profitable ether extraction by an arbitrary sender.

Parity surface: mythril/analysis/module/modules/ether_thief.py — after a
CALL/STATICCALL completes, defer a potential issue constrained so the
attacker ends strictly richer than they started, sending from their own
EOA."""

from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import UNPROTECTED_ETHER_WITHDRAWAL
from mythril_tpu_torch.laser.evm.transaction.symbolic import ACTORS
from mythril_tpu_torch.smt import UGT


class EtherThief(ProbeModule):
    name = "Any sender can withdraw ETH from the contract account"
    swc_id = UNPROTECTED_ETHER_WITHDRAWAL
    description = (
        "Search for cases where Ether can be withdrawn to a user-specified "
        "address: a valid end state where the attacker's balance increased."
    )
    post_hooks = ["CALL", "STATICCALL"]

    deferred = True
    title = "Unprotected Ether Withdrawal"
    severity = "High"
    description_head = "Any sender can withdraw Ether from the contract account."
    description_tail = (
        "Arbitrary senders other than the contract creator can profitably extract Ether "
        "from the contract account. Verify the business logic carefully and make sure that appropriate "
        "security controls are in place to prevent unexpected loss of funds."
    )

    def site_address(self, state):
        # post-hook: report the call site, not the instruction after it
        return state.get_current_instruction()["address"] - 1

    def probe(self, state):
        world = state.world_state
        attacker_profits = UGT(
            world.balances[ACTORS.attacker],
            world.starting_balances[ACTORS.attacker],
        )
        tx = state.current_transaction
        yield Finding(
            constraints=[
                attacker_profits,
                state.environment.sender == ACTORS.attacker,
                tx.caller == tx.origin,
            ]
        )


detector = EtherThief()
