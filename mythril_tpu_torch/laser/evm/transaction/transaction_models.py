"""Transaction models and the signal protocol.

Parity surface: mythril/laser/ethereum/transaction/transaction_models.py.
The engine's control flow for nested and ending transactions is exception
based: instruction semantics raise TransactionStartSignal when a
CALL/CREATE family opcode needs a child frame, and TransactionEndSignal
when STOP/RETURN/REVERT/SELFDESTRUCT finalizes one; LaserEVM.exec catches
both and manipulates the transaction stack."""

import logging
from copy import deepcopy
from itertools import count
from typing import Optional, Union

from mythril_tpu_torch.laser.evm.state.account import Account
from mythril_tpu_torch.laser.evm.state.calldata import (
    BaseCalldata,
    ConcreteCalldata,
    SymbolicCalldata,
)
from mythril_tpu_torch.laser.evm.state.environment import Environment
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState
from mythril_tpu_torch.laser.evm.state.world_state import WorldState
from mythril_tpu_torch.smt import BitVec, UGE, symbol_factory

log = logging.getLogger(__name__)

_tx_counter = count(1)


def get_next_transaction_id() -> str:
    return str(next(_tx_counter))


def reset_transaction_ids() -> None:
    global _tx_counter
    _tx_counter = count(1)


def _as_word(value) -> BitVec:
    return value if isinstance(value, BitVec) else symbol_factory.BitVecVal(value, 256)


def transfer_ether(global_state: GlobalState, sender, receiver, value) -> None:
    """Move `value` wei with a solvency constraint on the sender."""
    value = _as_word(value)
    balances = global_state.world_state.balances
    global_state.world_state.constraints.append(UGE(balances[sender], value))
    balances[receiver] = balances[receiver] + value
    balances[sender] = balances[sender] - value


class TransactionEndSignal(Exception):
    """A transaction finalized (optionally by revert)."""

    def __init__(self, global_state: GlobalState, revert=False) -> None:
        self.global_state = global_state
        self.revert = revert


class TransactionStartSignal(Exception):
    """A nested transaction is starting."""

    def __init__(
        self,
        transaction: Union["MessageCallTransaction", "ContractCreationTransaction"],
        op_code: str,
        global_state: GlobalState,
    ) -> None:
        self.transaction = transaction
        self.op_code = op_code
        self.global_state = global_state


class BaseTransaction:
    """Shared transaction fields; unspecified symbolic fields are minted
    as fresh tx-scoped symbols."""

    def __init__(
        self,
        world_state: WorldState,
        callee_account: Account = None,
        caller=None,
        call_data=None,
        identifier: Optional[str] = None,
        gas_price=None,
        gas_limit=None,
        origin=None,
        code=None,
        call_value=None,
        init_call_data=True,
        static=False,
    ) -> None:
        assert isinstance(world_state, WorldState)
        self.world_state = world_state
        self.id = identifier or get_next_transaction_id()

        def default_symbol(name):
            return symbol_factory.BitVecSym("{}{}".format(name, self.id), 256)

        self.gas_price = gas_price if gas_price is not None else default_symbol("gasprice")
        self.origin = origin if origin is not None else default_symbol("origin")
        self.call_value = (
            call_value if call_value is not None else default_symbol("callvalue")
        )
        self.gas_limit = gas_limit
        self.code = code
        self.caller = caller
        self.callee_account = callee_account
        if call_data is None and init_call_data:
            self.call_data: BaseCalldata = SymbolicCalldata(self.id)
        elif isinstance(call_data, BaseCalldata):
            self.call_data = call_data
        else:
            self.call_data = ConcreteCalldata(self.id, [])
        self.static = static
        self.return_data: Optional[str] = None

    def initial_global_state_from_environment(
        self, environment, active_function
    ) -> GlobalState:
        """Mint the frame's first state and perform the value transfer."""
        global_state = GlobalState(self.world_state, environment, None)
        global_state.environment.active_function_name = active_function
        transfer_ether(
            global_state,
            environment.sender,
            environment.active_account.address,
            environment.callvalue,
        )
        return global_state

    def initial_global_state(self) -> GlobalState:
        raise NotImplementedError

    def __str__(self) -> str:
        callee = -1
        if self.callee_account is not None:
            callee = self.callee_account.address.value or -1
        return "{} {} from {} to {:#42x}".format(
            self.__class__.__name__, self.id, self.caller, callee
        )


class ContractCreationTransaction(BaseTransaction):
    """Deploys a contract; `end` installs the runtime bytecode the
    constructor returned."""

    def __init__(
        self,
        world_state: WorldState,
        caller=None,
        call_data=None,
        identifier: Optional[str] = None,
        gas_price=None,
        gas_limit=None,
        origin=None,
        code=None,
        call_value=None,
        contract_name=None,
        contract_address=None,
    ) -> None:
        # snapshot for revert-to-previous-world semantics on failure
        self.prev_world_state = deepcopy(world_state)
        creator_hex = None
        if caller is not None and caller.value is not None:
            creator_hex = hex(caller.value)
        callee_account = world_state.create_account(
            0,
            concrete_storage=True,
            creator=creator_hex,
            address=contract_address if isinstance(contract_address, int) else None,
        )
        if contract_name:
            callee_account.contract_name = contract_name
        # constructor arguments stay symbolic calldata: codecopy/codesize
        # compensate, which models them better than concrete emptiness
        super().__init__(
            world_state=world_state,
            callee_account=callee_account,
            caller=caller,
            call_data=call_data,
            identifier=identifier,
            gas_price=gas_price,
            gas_limit=gas_limit,
            origin=origin,
            code=code,
            call_value=call_value,
            init_call_data=True,
        )

    def initial_global_state(self) -> GlobalState:
        environment = Environment(
            self.callee_account,
            self.caller,
            self.call_data,
            self.gas_price,
            self.call_value,
            self.origin,
            self.code,
        )
        return self.initial_global_state_from_environment(
            environment, active_function="constructor"
        )

    def end(self, global_state: GlobalState, return_data=None, revert=False):
        valid_runtime_code = (
            return_data is not None
            and len(return_data) > 0
            and all(isinstance(b, int) for b in return_data)
        )
        if not valid_runtime_code:
            self.return_data = None
            raise TransactionEndSignal(global_state, revert=revert)
        account = global_state.environment.active_account
        account.code.assign_bytecode(bytes(return_data).hex())
        self.return_data = str(hex(account.address.value))
        assert account.code.instruction_list != []
        raise TransactionEndSignal(global_state, revert=revert)


class MessageCallTransaction(BaseTransaction):
    """A message call into an existing account."""

    def initial_global_state(self) -> GlobalState:
        environment = Environment(
            self.callee_account,
            self.caller,
            self.call_data,
            self.gas_price,
            self.call_value,
            self.origin,
            code=self.code or self.callee_account.code,
            static=self.static,
        )
        return self.initial_global_state_from_environment(
            environment, active_function="fallback"
        )

    def end(self, global_state: GlobalState, return_data=None, revert=False) -> None:
        self.return_data = return_data
        raise TransactionEndSignal(global_state, revert)
