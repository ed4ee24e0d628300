"""The EVM world state (yellow paper sigma).

Parity surface: mythril/laser/ethereum/state/world_state.py — the account
map, ONE shared symbolic balances array (plus its starting snapshot, which
detection modules compare against), the path condition, and the recorded
transaction sequence. Contract addresses derive from keccak(rlp([sender,
nonce])) via the in-repo RLP encoder below (replacing
ethereum.utils.mk_contract_address)."""

from copy import copy
from random import randint
from typing import Dict, Iterator, List

from mythril_tpu_torch.laser.evm.state.account import Account
from mythril_tpu_torch.laser.evm.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.evm.state.constraints import Constraints
from mythril_tpu_torch.support.keccak import keccak256
from mythril_tpu_torch.smt import Array, BitVec, symbol_factory

# ------------------------------------------------------------------- RLP


def _rlp_length_prefix(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    length_bytes = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(length_bytes)]) + length_bytes


def _rlp_encode(item) -> bytes:
    """Minimal RLP (bytes / int / list) — just enough for address
    derivation."""
    if isinstance(item, int):
        payload = b"" if item == 0 else item.to_bytes(
            (item.bit_length() + 7) // 8, "big"
        )
        return _rlp_encode(payload)
    if isinstance(item, (bytes, bytearray)):
        if len(item) == 1 and item[0] < 0x80:
            return bytes(item)
        return _rlp_length_prefix(len(item), 0x80) + bytes(item)
    if isinstance(item, list):
        payload = b"".join(_rlp_encode(x) for x in item)
        return _rlp_length_prefix(len(payload), 0xC0) + payload
    raise TypeError("cannot rlp-encode %r" % type(item))


def mk_contract_address(sender: bytes, nonce: int) -> bytes:
    """CREATE address: keccak(rlp([sender, nonce]))[12:]."""
    return keccak256(_rlp_encode([sender, nonce]))[12:]


# ----------------------------------------------------------- world state


class WorldState:
    def __init__(
        self,
        transaction_sequence=None,
        annotations: List[StateAnnotation] = None,
        constraints: Constraints = None,
    ) -> None:
        self._accounts: Dict[int, Account] = {}
        self.balances = Array("balance", 256, 256)
        self.starting_balances = copy(self.balances)
        self.constraints = constraints or Constraints()
        self.node = None
        self.transaction_sequence = transaction_sequence or []
        self._annotations = annotations or []

    # -- account access ------------------------------------------------------

    @property
    def accounts(self):
        return self._accounts

    def __getitem__(self, item: BitVec) -> Account:
        """Accounts auto-create on first touch (symbolic world)."""
        account = self._accounts.get(item.value)
        if account is None:
            account = Account(address=item, code=None, balances=self.balances)
            self._accounts[item.value] = account
        return account

    def put_account(self, account: Account) -> None:
        self._accounts[account.address.value] = account
        account._balances = self.balances
        account.balance = lambda: account._balances[account.address]

    def accounts_exist_or_load(self, addr, dynamic_loader) -> Account:
        """Existing account, or one populated through the dynamic loader."""
        if isinstance(addr, BitVec):
            address = addr
        elif isinstance(addr, int):
            address = symbol_factory.BitVecVal(addr, 256)
        else:
            address = symbol_factory.BitVecVal(int(addr, 16), 256)

        known = self._accounts.get(address.value)
        if known is not None:
            return known
        if dynamic_loader is None:
            raise ValueError("dynamic_loader is None")

        addr_hex = (
            addr if isinstance(addr, str) else "{0:#0{1}x}".format(address.value, 42)
        )
        code = dynamic_loader.dynld(addr_hex)
        try:
            balance = dynamic_loader.read_balance(addr_hex)
        except Exception:
            balance = 0
        return self.create_account(
            balance=balance,
            address=address.value,
            dynamic_loader=dynamic_loader,
            code=code,
        )

    def create_account(
        self,
        balance=0,
        address=None,
        concrete_storage=False,
        dynamic_loader=None,
        creator=None,
        code=None,
        nonce=0,
    ) -> Account:
        if address is not None:
            address_word = symbol_factory.BitVecVal(address, 256)
        else:
            address_word = self._generate_new_address(creator)
        account = Account(
            address=address_word,
            balances=self.balances,
            dynamic_loader=dynamic_loader,
            concrete_storage=concrete_storage,
        )
        if code:
            account.code = code
        account.nonce = nonce
        account.set_balance(
            balance
            if isinstance(balance, BitVec)
            else symbol_factory.BitVecVal(balance, 256)
        )
        self.put_account(account)
        return account

    def create_initialized_contract_account(self, contract_code, storage) -> None:
        """Contract account from runtime bytecode + pre-filled storage."""
        account = Account(
            self._generate_new_address(), code=contract_code, balances=self.balances
        )
        account.storage = storage
        self.put_account(account)

    def _generate_new_address(self, creator=None) -> BitVec:
        if creator:
            creator_hex = creator[2:] if creator.startswith("0x") else creator
            derived = mk_contract_address(bytes.fromhex(creator_hex.zfill(40)), 0)
            return symbol_factory.BitVecVal(int.from_bytes(derived, "big"), 256)
        while True:
            candidate = randint(0, 2 ** 160 - 1)
            if candidate not in self._accounts:
                return symbol_factory.BitVecVal(candidate, 256)

    # -- forking / annotations ------------------------------------------------

    def __copy__(self) -> "WorldState":
        clone = WorldState(
            transaction_sequence=self.transaction_sequence[:],
            annotations=[copy(a) for a in self._annotations],
        )
        clone.balances = copy(self.balances)
        clone.starting_balances = copy(self.starting_balances)
        for account in self._accounts.values():
            clone.put_account(copy(account))
        clone.node = self.node
        clone.constraints = copy(self.constraints)
        return clone

    def annotate(self, annotation: StateAnnotation) -> None:
        self._annotations.append(annotation)

    @property
    def annotations(self) -> List[StateAnnotation]:
        return self._annotations

    def get_annotations(self, annotation_type: type) -> Iterator[StateAnnotation]:
        return (a for a in self._annotations if isinstance(a, annotation_type))
