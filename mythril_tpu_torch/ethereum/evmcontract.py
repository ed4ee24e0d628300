"""Bytecode contract container (reference surface:
mythril/ethereum/evmcontract.py): runtime + creation code with lazy
disassembly and library-link-placeholder scrubbing."""

import logging
import re

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.support.support_utils import get_code_hash

log = logging.getLogger(__name__)


class EVMContract:
    """A contract holding runtime and creation bytecode."""

    def __init__(self, code="", creation_code="", name="Unknown", enable_online_lookup=False):
        code = _replace_library_placeholders(code)
        creation_code = _replace_library_placeholders(creation_code)
        self.creation_code = creation_code
        self.name = name
        self.code = code
        self.disassembly = Disassembly(code, enable_online_lookup=enable_online_lookup)
        self.creation_disassembly = Disassembly(
            creation_code, enable_online_lookup=enable_online_lookup
        )

    @property
    def bytecode_hash(self) -> str:
        return get_code_hash(self.code)

    @property
    def creation_bytecode_hash(self) -> str:
        return get_code_hash(self.creation_code)

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "code": self.code,
            "creation_code": self.creation_code,
            "disassembly": self.disassembly,
        }

    def get_easm(self) -> str:
        return self.disassembly.get_easm()

    def get_creation_easm(self) -> str:
        return self.creation_disassembly.get_easm()


def _replace_library_placeholders(code: str) -> str:
    """Solidity leaves __LibraryName____ placeholders in unlinked bytecode;
    scrub them so the code parses."""
    return re.sub(r"(__+.{1,36}?__+)", "aa" * 20, code)
