"""Fully-symbolic transaction setup.

Parity surface: mythril/laser/ethereum/transaction/symbolic.py — one
unconstrained message call per open world state (symbolic calldata,
value, gas price; the sender constrained into the ACTORS set), and the
creation transaction that starts an analysis."""

import logging
from typing import Optional

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser.evm.state.account import Account
from mythril_tpu_torch.laser.evm.state.calldata import SymbolicCalldata
from mythril_tpu_torch.laser.evm.state.world_state import WorldState
from mythril_tpu_torch.laser.evm.transaction.dispatch import enqueue_transaction
from mythril_tpu_torch.laser.evm.transaction.transaction_models import (
    ContractCreationTransaction,
    MessageCallTransaction,
    get_next_transaction_id,
)
from mythril_tpu_torch.smt import BitVec, Or, symbol_factory

log = logging.getLogger(__name__)

BLOCK_GAS_LIMIT = 8_000_000


class Actors:
    """The fixed sender addresses the analysis reasons about."""

    def __init__(
        self,
        creator=0xAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFE,
        attacker=0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF,
        someguy=0xAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA,
    ):
        self.addresses = {
            "CREATOR": symbol_factory.BitVecVal(creator, 256),
            "ATTACKER": symbol_factory.BitVecVal(attacker, 256),
            "SOMEGUY": symbol_factory.BitVecVal(someguy, 256),
        }

    def __setitem__(self, actor: str, address: Optional[str]):
        if address is None:
            if actor in ("CREATOR", "ATTACKER"):
                raise ValueError("Can't delete creator or attacker address")
            del self.addresses[actor]
            return
        if not address.startswith("0x"):
            raise ValueError("Actor address not in valid format")
        self.addresses[actor] = symbol_factory.BitVecVal(int(address[2:], 16), 256)

    def __getitem__(self, actor: str):
        return self.addresses[actor]

    @property
    def creator(self):
        return self.addresses["CREATOR"]

    @property
    def attacker(self):
        return self.addresses["ATTACKER"]

    def __len__(self):
        return len(self.addresses)


ACTORS = Actors()


def _fresh_symbol(prefix: str, tx_id) -> BitVec:
    return symbol_factory.BitVecSym("{}{}".format(prefix, tx_id), 256)


def execute_message_call(laser_evm, callee_address: BitVec) -> None:
    """One fully-symbolic message call per open world state."""
    open_states = laser_evm.open_states[:]
    del laser_evm.open_states[:]

    for world_state in open_states:
        if world_state[callee_address].deleted:
            log.debug("Can not execute dead contract, skipping.")
            continue
        tx_id = get_next_transaction_id()
        sender = _fresh_symbol("sender_", tx_id)
        transaction = MessageCallTransaction(
            world_state=world_state,
            identifier=tx_id,
            gas_price=_fresh_symbol("gas_price", tx_id),
            gas_limit=BLOCK_GAS_LIMIT,
            origin=sender,
            caller=sender,
            callee_account=world_state[callee_address],
            call_data=SymbolicCalldata(tx_id),
            call_value=_fresh_symbol("call_value", tx_id),
        )
        enqueue_transaction(
            laser_evm,
            transaction,
            extra_constraints=[
                Or(
                    *[
                        transaction.caller == actor
                        for actor in ACTORS.addresses.values()
                    ]
                )
            ],
        )

    laser_evm.exec()


def execute_contract_creation(
    laser_evm, contract_initialization_code, contract_name=None, world_state=None
) -> Account:
    """The creation transaction an analysis starts from."""
    del laser_evm.open_states[:]
    world_state = world_state or WorldState()

    tx_id = get_next_transaction_id()
    transaction = ContractCreationTransaction(
        world_state=world_state,
        identifier=tx_id,
        gas_price=_fresh_symbol("gas_price", tx_id),
        gas_limit=BLOCK_GAS_LIMIT,
        origin=ACTORS["CREATOR"],
        code=Disassembly(contract_initialization_code),
        caller=ACTORS["CREATOR"],
        contract_name=contract_name,
        call_data=None,
        call_value=_fresh_symbol("call_value", tx_id),
    )
    enqueue_transaction(
        laser_evm,
        transaction,
        extra_constraints=[
            Or(*[transaction.caller == actor for actor in ACTORS.addresses.values()])
        ],
    )
    laser_evm.exec(True)
    return transaction.callee_account
