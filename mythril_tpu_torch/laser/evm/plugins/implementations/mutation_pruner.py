"""Mutation pruner.

Parity surface:
mythril/laser/ethereum/plugins/implementations/mutation_pruner.py.

A message call that neither touched persistent state (no SSTORE / CALL /
STATICCALL executed) nor could have moved value leaves the world exactly
as it found it — exploring further transactions from that world state
duplicates work, so the open state is dropped."""

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.evm.plugins.implementations.plugin_annotations import (
    MutationAnnotation,
)
from mythril_tpu_torch.laser.evm.plugins.plugin import LaserPlugin
from mythril_tpu_torch.laser.evm.plugins.signals import PluginSkipWorldState
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState
from mythril_tpu_torch.laser.evm.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.smt import UGT, symbol_factory

MUTATING_OPS = ("SSTORE", "CALL", "STATICCALL")


def _value_transfer_possible(global_state: GlobalState) -> bool:
    callvalue = global_state.environment.callvalue
    if isinstance(callvalue, int):
        callvalue = symbol_factory.BitVecVal(callvalue, 256)
    try:
        solver.get_model(
            tuple(
                global_state.world_state.constraints
                + [UGT(callvalue, symbol_factory.BitVecVal(0, 256))]
            )
        )
        return True
    except UnsatError:
        return False


class MutationPruner(LaserPlugin):
    def initialize(self, symbolic_vm):
        def mark_mutation(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        # annotation-only and order-independent: the device bridge may
        # retire the opcode and re-fire this hook at lift time
        mark_mutation.tape_replay_safe = True

        for opcode in MUTATING_OPS:
            symbolic_vm.pre_hook(opcode)(mark_mutation)

        @symbolic_vm.laser_hook("add_world_state")
        def drop_clean_world_states(global_state: GlobalState):
            if isinstance(
                global_state.current_transaction, ContractCreationTransaction
            ):
                return
            if _value_transfer_possible(global_state):
                return  # balances changed: the state is not clean
            if not any(global_state.get_annotations(MutationAnnotation)):
                raise PluginSkipWorldState
