"""Shared transaction launch plumbing.

Both transaction front-ends (fully-symbolic analysis setup in symbolic.py
and the concrete conformance replay in concolic.py) end the same way: the
transaction's initial global state is minted, a CFG node is opened for it,
the world state records the transaction, and the state joins the work
list. That tail lives here once.

Parity surface: the *_setup_global_state_for_execution halves of
mythril/laser/ethereum/transaction/{symbolic,concolic}.py."""

from typing import Iterable, Optional

from mythril_tpu_torch.laser.evm.cfg import Edge, JumpType, Node
from mythril_tpu_torch.laser.evm.transaction.transaction_models import BaseTransaction


def enqueue_transaction(
    laser_evm,
    transaction: BaseTransaction,
    extra_constraints: Iterable = (),
    block_env: Optional[dict] = None,
):
    """Mint the initial state for `transaction` and put it on the work list.

    ``block_env`` pins the block context concretely (keys: number /
    timestamp / coinbase / difficulty / basefee as ints) — conformance
    fixtures specify these, and replays of dynamic jumps computed from
    NUMBER etc. need the real values."""
    global_state = transaction.initial_global_state()
    global_state.transaction_stack.append((transaction, None))

    for constraint in extra_constraints:
        global_state.world_state.constraints.append(constraint)

    if block_env:
        from mythril_tpu_torch.smt import symbol_factory

        environment = global_state.environment
        if "number" in block_env:
            environment.block_number = symbol_factory.BitVecVal(
                block_env["number"], 256
            )
        for key in ("timestamp", "coinbase", "difficulty", "basefee"):
            if key in block_env:
                environment.block_context[key] = symbol_factory.BitVecVal(
                    block_env[key], 256
                )

    node = Node(
        global_state.environment.active_account.contract_name,
        function_name=global_state.environment.active_function_name,
    )
    if laser_evm.requires_statespace:
        laser_evm.nodes[node.uid] = node
        if transaction.world_state.node:
            laser_evm.edges.append(
                Edge(
                    transaction.world_state.node.uid,
                    node.uid,
                    edge_type=JumpType.Transaction,
                    condition=None,
                )
            )
    if transaction.world_state.node:
        node.constraints = global_state.world_state.constraints

    global_state.world_state.transaction_sequence.append(transaction)
    global_state.node = node
    node.states.append(global_state)
    laser_evm.work_list.append(global_state)
    return global_state
