"""SWC-107: gas-forwarding call to an attacker-supplied address.

Parity surface: mythril/analysis/module/modules/external_calls.py — defer
a potential issue at every CALL whose callee can be the attacker with more
than stipend gas forwarded (the reentrancy precondition)."""

from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import REENTRANCY
from mythril_tpu_torch.laser.evm.transaction.symbolic import ACTORS
from mythril_tpu_torch.smt import UGT, symbol_factory

from mythril_tpu_torch.support.opcodes import GSTIPEND as GAS_STIPEND


class ExternalCalls(ProbeModule):
    name = "External call to another contract"
    swc_id = REENTRANCY
    description = (
        "Search for external calls with unrestricted gas to a user-specified address."
    )
    pre_hooks = ["CALL"]

    deferred = True
    title = "External Call To User-Supplied Address"
    severity = "Low"
    description_head = "A call to a user-supplied address is executed."
    description_tail = (
        "An external message call to an address specified by the caller is executed. Note that "
        "the callee account might contain arbitrary code and could re-enter any function "
        "within this contract. Reentering the contract in an intermediate state may lead to "
        "unexpected behaviour. Make sure that no state modifications "
        "are executed after this call and/or reentrancy guards are in place."
    )

    def probe(self, state):
        gas, callee = state.mstate.stack[-1], state.mstate.stack[-2]
        yield Finding(
            constraints=[
                UGT(gas, symbol_factory.BitVecVal(GAS_STIPEND, 256)),
                callee == ACTORS.attacker,
            ]
        )


detector = ExternalCalls()
