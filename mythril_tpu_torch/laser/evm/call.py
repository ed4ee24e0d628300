"""Call-parameter extraction for the CALL opcode family.

Parity surface: mythril/laser/ethereum/call.py — pop the stack operand
block, resolve the callee (looking symbolic Storage[i] addresses up
on-chain through the dynamic loader when possible), build the calldata
view for the child frame, and short-circuit precompile targets."""

import logging
import re
from typing import List, Optional, Union, cast

from mythril_tpu_torch.laser.evm import natives, util
from mythril_tpu_torch.laser.evm.state.account import Account
from mythril_tpu_torch.laser.evm.state.calldata import (
    BaseCalldata,
    ConcreteCalldata,
    SymbolicCalldata,
)
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState
from mythril_tpu_torch.support.opcodes import GSTIPEND, calculate_native_gas
from mythril_tpu_torch.smt import BitVec, Expression, If, is_true, simplify, symbol_factory

log = logging.getLogger(__name__)

_ADDRESS_RE = re.compile(r"^0x[0-9a-f]{40}$")
_STORAGE_SLOT_RE = re.compile(r"Storage\[(\d+)\]")


def _word(value) -> BitVec:
    return (
        symbol_factory.BitVecVal(value, 256) if isinstance(value, int) else value
    )


def _padded_address(address: int) -> str:
    return "0x" + hex(address)[2:].zfill(40)


def get_call_parameters(global_state: GlobalState, dynamic_loader, with_value=False):
    """Pop the operand block and resolve everything a child call needs.

    :return: (callee_address, callee_account, call_data, value, gas,
              memory_out_offset, memory_out_size)
    """
    gas, to = global_state.mstate.pop(2)
    value = global_state.mstate.pop() if with_value else 0
    in_offset, in_size, out_offset, out_size = global_state.mstate.pop(4)

    callee_address = get_callee_address(global_state, dynamic_loader, to)
    call_data = get_call_data(global_state, in_offset, in_size)

    callee_account = None
    needs_account = isinstance(callee_address, BitVec) or (
        isinstance(callee_address, str)
        and (
            int(callee_address, 16) > natives.PRECOMPILE_COUNT
            or int(callee_address, 16) == 0
        )
    )
    if needs_account:
        callee_account = get_callee_account(
            global_state, callee_address, dynamic_loader
        )

    # value-bearing calls hand the callee the 2300 gas stipend
    gas = gas + If(value > 0, symbol_factory.BitVecVal(GSTIPEND, gas.size()), 0)
    return callee_address, callee_account, call_data, value, gas, out_offset, out_size


def get_callee_address(
    global_state: GlobalState, dynamic_loader, symbolic_to_address: Expression
):
    """Concretize the callee when possible; a Storage[i]-shaped symbolic
    address is read from the chain when a dynamic loader is active."""
    try:
        return _padded_address(util.get_concrete_int(symbolic_to_address))
    except TypeError:
        log.debug("Symbolic call encountered")

    match = _STORAGE_SLOT_RE.search(str(simplify(symbolic_to_address)))
    if match is None or dynamic_loader is None:
        return symbolic_to_address

    slot = int(match.group(1))
    log.debug("Dynamic contract address at storage index %d", slot)
    contract = "0x{:040X}".format(
        global_state.environment.active_account.address.value
    )
    try:
        resolved = dynamic_loader.read_storage(contract, slot)
    except Exception:
        return symbolic_to_address
    if not _ADDRESS_RE.match(resolved):
        resolved = "0x" + resolved[26:]
    return resolved


def get_callee_account(
    global_state: GlobalState, callee_address: Union[str, BitVec], dynamic_loader
):
    """The callee's account, auto-created or chain-loaded as needed."""
    if isinstance(callee_address, BitVec):
        if callee_address.symbolic:
            return Account(
                callee_address, balances=global_state.world_state.balances
            )
        callee_address = hex(callee_address.value)[2:]
    try:
        return global_state.world_state.accounts_exist_or_load(
            callee_address, dynamic_loader
        )
    except ValueError:
        # no dynamic loader: fall back to an auto-created empty account
        return global_state.world_state[
            symbol_factory.BitVecVal(int(callee_address, 16), 256)
        ]


def get_call_data(
    global_state: GlobalState,
    memory_start: Union[int, BitVec],
    memory_size: Union[int, BitVec],
):
    """Child-frame calldata: the caller's calldata is reused when the whole
    window is forwarded; otherwise the memory slice is snapshotted."""
    state = global_state.mstate
    tx_id = "{}_internalcall".format(global_state.current_transaction.id)
    memory_start = cast(BitVec, _word(memory_start))
    memory_size = cast(BitVec, _word(memory_size))

    forwards_everything = simplify(
        memory_size == global_state.environment.calldata.calldatasize
    )
    if is_true(forwards_everything):
        return global_state.environment.calldata

    try:
        window = state.memory[
            util.get_concrete_int(memory_start) : util.get_concrete_int(
                memory_start + memory_size
            )
        ]
        return ConcreteCalldata(tx_id, window)
    except TypeError:
        log.debug(
            "Unsupported symbolic memory offset %s size %s", memory_start, memory_size
        )
        return SymbolicCalldata(tx_id)


def insert_ret_val(global_state: GlobalState):
    """Push a success retval constrained to 1 (precompiles don't fail)."""
    retval = global_state.new_bitvec(
        "retval_" + str(global_state.get_current_instruction()["address"]), 256
    )
    global_state.mstate.stack.append(retval)
    global_state.world_state.constraints.append(retval == 1)


def native_call(
    global_state: GlobalState,
    callee_address: Union[str, BitVec],
    call_data: BaseCalldata,
    memory_out_offset: Union[int, Expression],
    memory_out_size: Union[int, Expression],
) -> Optional[List[GlobalState]]:
    """Execute a precompile target in place; None when the callee is not a
    precompile (the caller then starts a real child transaction)."""
    if (
        isinstance(callee_address, BitVec)
        or not 0 < int(callee_address, 16) <= natives.PRECOMPILE_COUNT
    ):
        return None

    log.debug("Native contract called: %s", callee_address)
    try:
        out_start = util.get_concrete_int(memory_out_offset)
        out_size = util.get_concrete_int(memory_out_size)
    except TypeError:
        log.debug("CALL with symbolic start or offset not supported")
        return [global_state]

    which = int(callee_address, 16)
    handler_name = natives.PRECOMPILE_FUNCTIONS[which - 1].__name__
    gas_min, gas_max = calculate_native_gas(
        global_state.mstate.calculate_extension_size(out_start, out_size),
        handler_name,
    )
    global_state.mstate.min_gas_used += gas_min
    global_state.mstate.max_gas_used += gas_max
    global_state.mstate.mem_extend(out_start, out_size)

    try:
        data = natives.native_contracts(which, call_data)
    except natives.NativeContractException:
        # symbolic input: the output window becomes fresh symbols
        for i in range(out_size):
            global_state.mstate.memory[out_start + i] = global_state.new_bitvec(
                "{}({})".format(handler_name, call_data), 8
            )
        insert_ret_val(global_state)
        return [global_state]

    for i in range(min(len(data), out_size)):  # excess output is chopped off
        global_state.mstate.memory[out_start + i] = data[i]
    insert_ret_val(global_state)
    return [global_state]
