"""SWC-112: delegatecall into an attacker-supplied contract.

Parity surface: mythril/analysis/module/modules/delegatecall.py — defer a
potential issue constrained so the callee is the attacker, gas is
forwarded, the (fresh) return value is success, and every message-call
sender is the attacker."""

from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import DELEGATECALL_TO_UNTRUSTED_CONTRACT
from mythril_tpu_torch.laser.evm.transaction.symbolic import ACTORS
from mythril_tpu_torch.laser.evm.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.smt import UGT, symbol_factory


class ArbitraryDelegateCall(ProbeModule):
    name = "Delegatecall to a user-specified address"
    swc_id = DELEGATECALL_TO_UNTRUSTED_CONTRACT
    description = "Check for invocations of delegatecall to a user-supplied address."
    pre_hooks = ["DELEGATECALL"]

    deferred = True
    title = "Delegatecall to user-supplied address"
    severity = "High"
    description_head = (
        "The contract delegates execution to another contract with a user-supplied address."
    )
    description_tail = (
        "The smart contract delegates execution to a user-supplied address.This could allow an attacker to "
        "execute arbitrary code in the context of this contract account and manipulate the state of the "
        "contract account or execute actions on its behalf."
    )

    def probe(self, state):
        gas, callee = state.mstate.stack[-1], state.mstate.stack[-2]
        site = state.get_current_instruction()["address"]
        pins = [
            tx.caller == ACTORS.attacker
            for tx in state.world_state.transaction_sequence
            if not isinstance(tx, ContractCreationTransaction)
        ]
        yield Finding(
            constraints=[
                callee == ACTORS.attacker,
                UGT(gas, symbol_factory.BitVecVal(2300, 256)),
                state.new_bitvec("retval_{}".format(site), 256) == 1,
            ]
            + pins
        )


detector = ArbitraryDelegateCall()
