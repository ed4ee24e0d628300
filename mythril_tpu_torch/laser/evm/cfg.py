"""Control-flow-graph nodes and edges recorded during symbolic execution
(reference surface: mythril/laser/ethereum/cfg.py)."""

import itertools
from enum import Enum
from typing import Dict, List


class JumpType(Enum):
    """Edge types in the CFG."""

    CONDITIONAL = 1
    UNCONDITIONAL = 2
    CALL = 3
    RETURN = 4
    Transaction = 5


class NodeFlags:
    FUNC_ENTRY = 1
    CALL_RETURN = 2


# itertools.count().__next__ is atomic under the GIL, so concurrent node
# creation (device lift threads + host loop) can never mint duplicate uids
# the way the old `global gbl_next_uid; gbl_next_uid += 1` pair could
_next_uid = itertools.count()


class Node:
    """A basic-block node in the CFG."""

    def __init__(self, contract_name: str, start_addr=0, constraints=None, function_name="unknown"):
        constraints = constraints if constraints else []
        self.contract_name = contract_name
        self.start_addr = start_addr
        self.states: List = []
        self.constraints = constraints
        self.function_name = function_name
        self.flags = 0
        self.uid = next(_next_uid)

    def __repr__(self) -> str:
        return (
            "<Node uid={0.uid} contract={0.contract_name!r} "
            "start_addr={0.start_addr!r} function={0.function_name!r} "
            "states={1}>"
        ).format(self, len(self.states))

    def get_cfg_dict(self) -> Dict:
        code_lines = []
        for state in self.states:
            instruction = state.get_current_instruction()
            code_line = "%d %s" % (instruction["address"], instruction["opcode"])
            if instruction.get("argument"):
                code_line += " " + instruction["argument"]
            code_lines.append(code_line)
        return dict(
            contract_name=self.contract_name,
            start_addr=self.start_addr,
            function_name=self.function_name,
            code="\\n".join(code_lines),
        )


class Edge:
    """A CFG edge."""

    def __init__(self, node_from: int, node_to: int, edge_type=JumpType.UNCONDITIONAL, condition=None):
        self.node_from = node_from
        self.node_to = node_to
        self.type = edge_type
        self.condition = condition

    def __str__(self) -> str:
        return str(self.as_dict)

    @property
    def as_dict(self) -> Dict[str, int]:
        return {"from": self.node_from, "to": self.node_to}
