"""Per-frame execution environment (yellow paper I).

Parity surface: mythril/laser/ethereum/state/environment.py — the active
account and call context one frame executes under, plus the static-call
flag. block_number/chainid are minted symbolic once per frame; the
block_context dict pins concrete block values during concolic replay."""

from typing import Dict

from mythril_tpu_torch.laser.evm.state.account import Account
from mythril_tpu_torch.laser.evm.state.calldata import BaseCalldata
from mythril_tpu_torch.smt import symbol_factory


class Environment:
    __slots__ = (
        "active_account",
        "active_function_name",
        "address",
        "block_number",
        "chainid",
        "block_context",
        "code",
        "sender",
        "calldata",
        "gasprice",
        "origin",
        "callvalue",
        "static",
    )

    def __str__(self) -> str:
        return str(self.as_dict)

    @property
    def as_dict(self) -> Dict:
        return dict(
            active_account=self.active_account,
            sender=self.sender,
            calldata=self.calldata,
            gasprice=self.gasprice,
            callvalue=self.callvalue,
            origin=self.origin,
        )

    def __init__(
        self,
        active_account: Account,
        sender,
        calldata: BaseCalldata,
        gasprice,
        callvalue,
        origin,
        code=None,
        static=False,
    ) -> None:
        self.active_account = active_account
        self.active_function_name = ""
        self.address = active_account.address
        self.block_number = symbol_factory.BitVecSym("block_number", 256)
        self.chainid = symbol_factory.BitVecSym("chain_id", 256)
        # concrete block context for concolic replay (VMTests): keys
        # "timestamp"/"coinbase"/"difficulty"/"basefee" override the fresh
        # symbols the block opcodes mint during symbolic analysis
        self.block_context: Dict = {}
        self.code = active_account.code if code is None else code
        self.sender = sender
        self.calldata = calldata
        self.gasprice = gasprice
        self.origin = origin
        self.callvalue = callvalue
        self.static = static
