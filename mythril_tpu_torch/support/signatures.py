"""Function-signature database (reference surface: mythril/support/signatures.py).

Maps 4-byte selectors to text signatures. Backed by sqlite (stdlib) at
``$MYTHRIL_TPU_DIR/signatures.db`` with an in-repo seed of common selectors;
supports importing signatures from solidity sources and (optionally, off by
default) querying 4byte.directory online.
"""

import logging
import os
import re
import sqlite3
import threading
from typing import List, Optional

from mythril_tpu_torch.support.keccak import keccak256

log = logging.getLogger(__name__)

lock = threading.Lock()

# seed of very common selectors so fresh installs resolve typical ERC-20 ABIs
_SEED_SIGNATURES = [
    "transfer(address,uint256)",
    "transferFrom(address,address,uint256)",
    "approve(address,uint256)",
    "balanceOf(address)",
    "allowance(address,address)",
    "totalSupply()",
    "owner()",
    "name()",
    "symbol()",
    "decimals()",
    "mint(address,uint256)",
    "burn(uint256)",
    "withdraw()",
    "withdraw(uint256)",
    "deposit()",
    "kill()",
    "fallback()",
    "batchTransfer(address[],uint256)",
    "transferOwnership(address)",
    "initWallet(address[],uint256,uint256)",
    "sendMultiSig(address,uint256,bytes)",
]


def hash_signature(sig: str) -> str:
    """4-byte selector hex (0x-prefixed) of a canonical text signature."""
    return "0x" + keccak256(sig.encode()).hex()[:8]


class SignatureDB(object):
    def __init__(self, enable_online_lookup: bool = False, path: Optional[str] = None):
        self.enable_online_lookup = enable_online_lookup
        self.online_lookup_miss = set()
        if path is None:
            mythril_dir = os.environ.get(
                "MYTHRIL_TPU_DIR", os.path.join(os.path.expanduser("~"), ".mythril_tpu_torch")
            )
            os.makedirs(mythril_dir, exist_ok=True)
            path = os.path.join(mythril_dir, "signatures.db")
        self.path = path
        with lock, sqlite3.connect(self.path) as conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS signatures "
                "(byte_sig VARCHAR(10), text_sig VARCHAR(255), "
                "PRIMARY KEY (byte_sig, text_sig))"
            )
            for sig in _SEED_SIGNATURES:
                conn.execute(
                    "INSERT OR IGNORE INTO signatures (byte_sig, text_sig) VALUES (?, ?)",
                    (hash_signature(sig), sig),
                )

    def __getitem__(self, item: str) -> List[str]:
        return self.get(item)

    def add(self, byte_sig: str, text_sig: str) -> None:
        with lock, sqlite3.connect(self.path) as conn:
            conn.execute(
                "INSERT OR IGNORE INTO signatures (byte_sig, text_sig) VALUES (?, ?)",
                (byte_sig, text_sig),
            )

    def get(self, byte_sig: str, online_timeout: int = 2) -> List[str]:
        """All known text signatures for a selector."""
        if not byte_sig.startswith("0x"):
            byte_sig = "0x" + byte_sig
        with lock, sqlite3.connect(self.path) as conn:
            rows = conn.execute(
                "SELECT text_sig FROM signatures WHERE byte_sig = ?", (byte_sig,)
            ).fetchall()
        if rows:
            return [r[0] for r in rows]
        if self.enable_online_lookup and byte_sig not in self.online_lookup_miss:
            results = self.lookup_online(byte_sig, timeout=online_timeout)
            if results:
                for t in results:
                    self.add(byte_sig, t)
                return results
            self.online_lookup_miss.add(byte_sig)
        return []

    def import_solidity_file(
        self, file_path: str, solc_binary: str = "solc", solc_settings_json: str = None
    ) -> None:
        """Parse function signatures out of a solidity source (regex-based;
        avoids requiring solc for signature import)."""
        try:
            with open(file_path) as f:
                code = f.read()
        except OSError as e:
            log.warning("could not read %s: %s", file_path, e)
            return
        funcs = re.findall(r"function\s+(\w+)\s*\(([^)]*)\)", code)
        for name, params in funcs:
            arg_types = []
            for param in params.split(","):
                param = param.strip()
                if not param:
                    continue
                base = param.split()[0]
                # canonicalize common aliases
                base = {"uint": "uint256", "int": "int256", "byte": "bytes1"}.get(base, base)
                arg_types.append(base)
            sig = "%s(%s)" % (name, ",".join(arg_types))
            self.add(hash_signature(sig), sig)

    @staticmethod
    def lookup_online(byte_sig: str, timeout: int, proxies=None) -> List[str]:
        """Query 4byte.directory (disabled unless enable_online_lookup)."""
        try:
            import requests

            resp = requests.get(
                "https://www.4byte.directory/api/v1/signatures/",
                params={"hex_signature": byte_sig},
                timeout=timeout,
                proxies=proxies,
            )
            return [r["text_signature"] for r in resp.json().get("results", [])]
        except Exception:
            return []
