"""Accounts and their storage.

Parity surface: mythril/laser/ethereum/state/account.py. Storage wraps an
array term — K(0) when the account's pre-state is known concretely, an
unconstrained Array otherwise — plus a printable mirror of touched slots
and optional on-chain lazy loading. An Account's balance reads through
the world state's SHARED balances array (one array for all accounts, so
inter-account transfers stay one term graph)."""

import logging
from copy import copy, deepcopy
from typing import Any, Dict, Set, Union

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.smt import Array, BaseArray, BitVec, K, simplify, symbol_factory

log = logging.getLogger(__name__)


class Storage:
    """One account's storage: array term + touched-slot bookkeeping."""

    __slots__ = (
        "_backing",
        "printable_storage",
        "dynld",
        "storage_keys_loaded",
        "address",
    )

    def __init__(
        self, concrete: bool = False, address: BitVec = None, dynamic_loader=None
    ) -> None:
        self._backing: BaseArray = (
            K(256, 256, 0) if concrete else Array("Storage", 256, 256)
        )
        self.printable_storage: Dict[BitVec, BitVec] = {}
        self.dynld = dynamic_loader
        self.storage_keys_loaded: Set[int] = set()
        self.address = address

    def _should_load_on_chain(self, key: BitVec) -> bool:
        return (
            self.address is not None
            and self.address.value not in (None, 0)
            and key.symbolic is False
            and int(key.value) not in self.storage_keys_loaded
            and self.dynld is not None
            and self.dynld.active
        )

    def _load_on_chain(self, key: BitVec) -> None:
        """Fill a concrete slot from the chain through the DynLoader."""
        try:
            on_chain = self.dynld.read_storage(
                contract_address="0x{:040X}".format(self.address.value),
                index=int(key.value),
            )
        except ValueError as e:
            log.debug("Couldn't read storage at %s: %s", key, e)
            return
        value = symbol_factory.BitVecVal(int(on_chain, 16), 256)
        self._backing[key] = value
        self.storage_keys_loaded.add(int(key.value))
        self.printable_storage[key] = value

    def __getitem__(self, key: BitVec) -> BitVec:
        if self._should_load_on_chain(key):
            self._load_on_chain(key)
        return simplify(self._backing[key])

    def __setitem__(self, key: BitVec, value: Any) -> None:
        self.printable_storage[key] = value
        self._backing[key] = value
        if key.symbolic is False:
            self.storage_keys_loaded.add(int(key.value))

    def __deepcopy__(self, memodict=None):
        clone = Storage(
            concrete=isinstance(self._backing, K),
            address=self.address,
            dynamic_loader=self.dynld,
        )
        # array terms are immutable: sharing the store chain IS the copy
        clone._backing = copy(self._backing)
        clone.printable_storage = copy(self.printable_storage)
        clone.storage_keys_loaded = copy(self.storage_keys_loaded)
        return clone

    def __str__(self) -> str:
        return str(self.printable_storage)


def _as_address(value: Union[BitVec, str]) -> BitVec:
    if isinstance(value, BitVec):
        return value
    return symbol_factory.BitVecVal(int(value, 16), 256)


class Account:
    """nonce / code / storage / deletion flag; balance closes over the
    world state's shared balances array."""

    def __init__(
        self,
        address: Union[BitVec, str],
        code: Disassembly = None,
        contract_name: str = None,
        balances: Array = None,
        concrete_storage: bool = False,
        dynamic_loader=None,
    ) -> None:
        self.nonce = 0
        self.code = code or Disassembly("")
        self.address = _as_address(address)
        self.storage = Storage(
            concrete_storage, address=self.address, dynamic_loader=dynamic_loader
        )
        if contract_name is not None:
            self.contract_name = contract_name
        elif self.address.symbolic:
            self.contract_name = "unknown"
        else:
            self.contract_name = "{0:#0{1}x}".format(self.address.value, 42)
        self.deleted = False
        self._balances = balances
        self.balance = lambda: self._balances[self.address]

    def set_balance(self, balance: Union[int, BitVec]) -> None:
        assert self._balances is not None
        if isinstance(balance, int):
            balance = symbol_factory.BitVecVal(balance, 256)
        self._balances[self.address] = balance

    def add_balance(self, balance: Union[int, BitVec]) -> None:
        if isinstance(balance, int):
            balance = symbol_factory.BitVecVal(balance, 256)
        self._balances[self.address] = self._balances[self.address] + balance

    def __copy__(self, memodict=None):
        clone = Account(
            address=self.address,
            code=self.code,
            contract_name=self.contract_name,
            balances=self._balances,
        )
        clone.storage = deepcopy(self.storage)
        clone.nonce = self.nonce
        clone.deleted = self.deleted
        return clone

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("balance", None)  # closure; rebuilt on load
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.balance = lambda: self._balances[self.address]

    def __str__(self) -> str:
        return str(self.as_dict)

    @property
    def as_dict(self) -> Dict:
        return {
            "nonce": self.nonce,
            "code": self.code,
            "balance": self.balance(),
            "storage": self.storage,
        }
