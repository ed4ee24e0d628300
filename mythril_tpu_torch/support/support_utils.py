"""Small shared utilities (reference surface: mythril/support/support_utils.py)."""

from typing import Dict

from mythril_tpu_torch.support.keccak import keccak256


class Singleton(type):
    """A metaclass type implementing the singleton pattern."""

    _instances: Dict = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super(Singleton, cls).__call__(*args, **kwargs)
        return cls._instances[cls]


def get_code_hash(code: str) -> str:
    """Hash the given EVM code (hex string, '0x'-prefixed or not).

    :return: 0x-prefixed keccak256 hex digest
    """
    code = code[2:] if code.startswith("0x") else code
    try:
        hash_ = keccak256(bytes.fromhex(code))
        return "0x" + hash_.hex()
    except ValueError:
        # invalid hex (e.g. unresolved library link placeholders)
        return "0x" + keccak256(code.encode()).hex()


def sha3(value: bytes) -> bytes:
    """Ethereum-style keccak256."""
    if isinstance(value, str):
        value = value.encode()
    return keccak256(value)


def zpad(data: bytes, length: int) -> bytes:
    """Left-pad with zero bytes to the given length."""
    return data.rjust(length, b"\x00")
