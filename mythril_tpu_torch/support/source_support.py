"""Source bookkeeping for jsonv2 reports (reference surface:
mythril/support/source_support.py)."""



class Source:
    """File list + hashes for report rendering."""

    def __init__(self, source_type=None, source_format=None, source_list=None):
        self.source_type = source_type
        self.source_format = source_format
        self.source_list = source_list or []
        self._source_hash = []

    def get_source_from_contracts_list(self, contracts) -> None:
        if contracts is None or len(contracts) == 0:
            return
        # solidity contracts carry filenames; raw bytecode contracts hash only
        first = contracts[0]
        if hasattr(first, "solidity_files"):
            self.source_type = "solidity-file"
            self.source_format = "text"
            for contract in contracts:
                self.source_list += [file.filename for file in contract.solidity_files]
                self._source_hash.append(contract.bytecode_hash)
                self._source_hash.append(contract.creation_bytecode_hash)
        elif hasattr(first, "bytecode_hash"):
            self.source_type = "raw-bytecode"
            self.source_format = "evm-byzantium-bytecode"
            for contract in contracts:
                if hasattr(contract, "creation_code"):
                    self.source_list.append(contract.creation_bytecode_hash)
                if hasattr(contract, "code"):
                    self.source_list.append(contract.bytecode_hash)
            self._source_hash = self.source_list

    def get_source_index(self, bytecode_hash: str) -> int:
        try:
            return self.source_list.index(bytecode_hash)
        except ValueError:
            self.source_list.append(bytecode_hash)
            return len(self.source_list) - 1
