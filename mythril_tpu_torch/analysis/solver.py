"""Witness extraction for detection modules.

Parity surface: mythril/analysis/solver.py — two entry points:

  get_model(constraints, minimize, maximize)
      one memoized Optimize solve (timeout coupled to the remaining
      execution budget), UnsatError on unsat/timeout;
  get_transaction_sequence(global_state, constraints)
      a full concrete witness: the path condition is solved under
      minimization objectives (small calldata, small call values, bounded
      starting balances), then every transaction in the sequence is
      concretized from the model, and placeholder hash values in calldata
      are replaced by real keccaks of their recovered preimages.
"""

import logging
from functools import lru_cache
from typing import Dict, List

from mythril_tpu_torch.analysis.analysis_args import analysis_args
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.evm.keccak_function_manager import (
    hash_matcher,
    keccak_function_manager,
)
from mythril_tpu_torch.laser.evm.state.constraints import Constraints
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState
from mythril_tpu_torch.laser.evm.time_handler import time_handler
from mythril_tpu_torch.laser.evm.transaction import BaseTransaction
from mythril_tpu_torch.laser.evm.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.smt import Optimize, UGE, sat, symbol_factory, unknown

log = logging.getLogger(__name__)

# "reasonable world" bounds for witness quality (same values as the
# reference): callers start with at most 1000 ETH, accounts with 100 ETH
MAX_CALLER_BALANCE = 10 ** 21
MAX_ACCOUNT_BALANCE = 10 ** 20
MAX_CALLDATA_BYTES = 5000


@lru_cache(maxsize=2 ** 23)
def get_model(constraints, minimize=(), maximize=(), enforce_execution_time=True):
    """One Optimize solve over the constraint set.

    :raises UnsatError: on unsat, timeout, or exhausted execution budget
    """
    timeout = analysis_args.solver_timeout
    if enforce_execution_time:
        timeout = min(timeout, time_handler.time_remaining() - 500)
        if timeout <= 0:
            raise UnsatError
    if any(type(c) == bool and not c for c in constraints):
        raise UnsatError

    solver = Optimize()
    solver.set_timeout(timeout)
    for constraint in constraints:
        if type(constraint) != bool:
            solver.add(constraint)
    for objective in minimize:
        solver.minimize(objective)
    for objective in maximize:
        solver.maximize(objective)

    outcome = solver.check()
    if outcome is sat:
        return solver.model()
    if outcome is unknown:
        log.debug("Timeout/incomplete result while solving expression")
    raise UnsatError


def pretty_print_model(model):
    return "".join("%s\n" % name for name in model.decls())


# ------------------------------------------------------- witness assembly


def get_transaction_sequence(
    global_state: GlobalState, constraints: Constraints
) -> Dict:
    """Concretize the whole transaction sequence leading to this state."""
    transactions = global_state.world_state.transaction_sequence
    world_state = global_state.world_state

    solve_constraints, objectives = _witness_objectives(
        transactions, constraints.copy(), world_state
    )
    model = get_model(tuple(solve_constraints), minimize=objectives)

    steps = [_concretize_transaction(model, tx) for tx in transactions]

    initial_world = transactions[0].world_state
    balances = {
        address: model.eval(
            initial_world.starting_balances[
                symbol_factory.BitVecVal(address, 256)
            ].raw,
            model_completion=True,
        ).value
        for address in initial_world.accounts
    }
    initial_state = _concretize_accounts(initial_world.accounts, balances)

    creation_code = (
        transactions[0].code
        if isinstance(transactions[0], ContractCreationTransaction)
        else None
    )
    _substitute_real_hashes(steps, model, creation_code)
    _mirror_calldata_fields(steps, transactions)
    return {"initialState": initial_state, "steps": steps}


def _witness_objectives(transactions, constraints, world_state):
    """Add witness-quality bounds and collect minimization objectives."""
    objectives: List = []
    calldata_cap = symbol_factory.BitVecVal(MAX_CALLDATA_BYTES, 256)
    for tx in transactions:
        constraints.append(UGE(calldata_cap, tx.call_data.calldatasize))
        objectives.append(tx.call_data.calldatasize)
        objectives.append(tx.call_value)
        constraints.append(
            UGE(
                symbol_factory.BitVecVal(MAX_CALLER_BALANCE, 256),
                world_state.starting_balances[tx.caller],
            )
        )
    for account in world_state.accounts.values():
        constraints.append(
            UGE(
                symbol_factory.BitVecVal(MAX_ACCOUNT_BALANCE, 256),
                world_state.starting_balances[account.address],
            )
        )
    return constraints, tuple(objectives)


def _concretize_transaction(model, transaction: BaseTransaction):
    caller_value = model.eval(transaction.caller.raw, model_completion=True).value
    call_value = model.eval(transaction.call_value.raw, model_completion=True).value

    payload = ""
    address = hex(transaction.callee_account.address.value)
    if isinstance(transaction, ContractCreationTransaction):
        address = ""
        payload += transaction.code.bytecode
    payload += "".join(
        "%02x" % (b if isinstance(b, int) else b.value)
        for b in transaction.call_data.concrete(model)
    )
    return {
        "input": "0x" + payload,
        "value": "0x%x" % call_value,
        "origin": "0x" + ("%x" % caller_value).zfill(40),
        "address": address,
    }


def _concretize_accounts(initial_accounts: Dict, balances: Dict[int, int]):
    accounts = {}
    for address, account in initial_accounts.items():
        accounts[hex(address)] = {
            "nonce": account.nonce,
            "code": account.code.bytecode,
            "storage": str(account.storage),
            "balance": hex(balances.get(address, 0)),
        }
    return {"accounts": accounts}


def _mirror_calldata_fields(steps, transactions):
    """Expose calldata separately from raw input (creation txs prepend the
    deploy code to input)."""
    for step in steps:
        step["calldata"] = step["input"]
    if isinstance(transactions[0], ContractCreationTransaction):
        code_len = len(transactions[0].code.bytecode)
        steps[0]["calldata"] = steps[0]["input"][code_len + 2 :]


def _substitute_real_hashes(steps, model, creation_code=None) -> None:
    """Swap placeholder hash stripes in concretized calldata for the real
    keccak of the preimage the model chose."""
    symbolic_hashes = keccak_function_manager.get_concrete_hash_data(model)
    for step in steps:
        payload = step["input"]
        if hash_matcher not in payload:
            continue
        if creation_code is not None and creation_code.bytecode in payload:
            scan_from = len(creation_code.bytecode) + 2
        else:
            scan_from = 10
        for i in range(scan_from, len(payload)):
            window = payload[i : i + 64]
            if len(window) != 64 or hash_matcher not in window:
                continue
            placeholder = symbol_factory.BitVecVal(int(window, 16), 256)
            preimage = None
            for size, values in symbolic_hashes.items():
                if placeholder.value not in values:
                    continue
                _, inverse = keccak_function_manager.store_function[size]
                recovered = model.eval(
                    inverse(placeholder).raw, model_completion=True
                )
                preimage = symbol_factory.BitVecVal(recovered.value, size)
            if preimage is None:
                continue
            real_hash = keccak_function_manager.find_concrete_keccak(preimage)
            real_hex = hex(real_hash.value)[2:].zfill(64)
            step["input"] = payload[:scan_from] + payload[scan_from:].replace(
                payload[i : i + 64], real_hex
            )
            payload = step["input"]
