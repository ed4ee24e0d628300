"""The complete execution state at one point of the search.

Parity surface: mythril/laser/ethereum/state/global_state.py — world
state x environment x machine state x transaction stack x annotations.
``__copy__`` is the hot per-instruction fork copy: shallow-copy world and
environment (terms are immutable), deep-copy the machine state, re-anchor
the active account into the copied world, and clone annotations."""

from copy import copy, deepcopy
from typing import Dict, Iterable, List

from mythril_tpu_torch.laser.evm.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.evm.state.environment import Environment
from mythril_tpu_torch.laser.evm.state.machine_state import MachineState
from mythril_tpu_torch.smt import BitVec, symbol_factory

_DEFAULT_FRAME_GAS = 1_000_000_000


class GlobalState:
    __slots__ = (
        "node",
        "world_state",
        "environment",
        "mstate",
        "transaction_stack",
        "op_code",
        "last_return_data",
        "_annotations",
        "_solver_prefix_fps",
        "_static_unsat",
        "_interval_seeds",
    )

    def __init__(
        self,
        world_state,
        environment: Environment,
        node,
        machine_state=None,
        transaction_stack=None,
        last_return_data=None,
        annotations=None,
    ) -> None:
        self.node = node
        self.world_state = world_state
        self.environment = environment
        self.mstate = machine_state or MachineState(gas_limit=_DEFAULT_FRAME_GAS)
        self.transaction_stack = transaction_stack or []
        self.op_code = ""
        self.last_return_data = last_return_data
        self._annotations = annotations or []
        # device path-prefix fingerprint chain (symtape.path_fingerprint),
        # attached by the bridge at lift time; the solver cache keys
        # warm-start models by these. Performance hint only.
        self._solver_prefix_fps = None
        # statically-proven contradiction: the device path tape recorded
        # a branch sign conflicting with a MUST jumpi_verdict fact; the
        # solver cache decides the state UNSAT without a solve
        self._static_unsat = False
        # MUST value bounds on lifted path-condition words, keyed by
        # term uid (bridge, from StaticAnalysis.cond_intervals); the
        # stage-3 rewrite pass consumes them as interval-discharge seeds
        self._interval_seeds = None

    # -- lookups --------------------------------------------------------------

    @property
    def accounts(self) -> Dict:
        return self.world_state._accounts

    def get_current_instruction(self) -> Dict:
        instructions = self.environment.code.instruction_list
        try:
            return instructions[self.mstate.pc]
        except IndexError:
            # running off the end of code halts (implicit STOP)
            return {"address": self.mstate.pc, "opcode": "STOP"}

    @property
    def instruction(self) -> Dict:
        return self.get_current_instruction()

    @property
    def current_transaction(self):
        if not self.transaction_stack:
            return None
        return self.transaction_stack[-1][0]

    def new_bitvec(self, name: str, size=256, annotations=None) -> BitVec:
        """Mint a transaction-scoped symbol (names are unique per tx)."""
        return symbol_factory.BitVecSym(
            "{}_{}".format(self.current_transaction.id, name),
            size,
            annotations=annotations,
        )

    # -- annotations ----------------------------------------------------------

    def annotate(self, annotation: StateAnnotation) -> None:
        self._annotations.append(annotation)
        if annotation.persist_to_world_state:
            self.world_state.annotate(annotation)

    def add_annotations(self, annotations: List[StateAnnotation]):
        self._annotations += annotations

    @property
    def annotations(self) -> List[StateAnnotation]:
        return self._annotations

    def get_annotations(self, annotation_type: type) -> Iterable[StateAnnotation]:
        return (a for a in self._annotations if isinstance(a, annotation_type))

    # -- forking --------------------------------------------------------------

    def __copy__(self) -> "GlobalState":
        world_state = copy(self.world_state)
        environment = copy(self.environment)
        # the copied frame must act on the copied world's account object
        environment.active_account = world_state[environment.active_account.address]
        dup = GlobalState(
            world_state,
            environment,
            self.node,
            deepcopy(self.mstate),
            transaction_stack=copy(self.transaction_stack),
            last_return_data=self.last_return_data,
            annotations=[copy(a) for a in self._annotations],
        )
        # a host-forked child extends the path host-side; its DEVICE
        # prefix (the warm-start lookup chain) is unchanged
        dup._solver_prefix_fps = self._solver_prefix_fps
        # a contradicted prefix stays contradicted in every descendant
        dup._static_unsat = self._static_unsat
        # interval facts hold at the sites the prefix passed through,
        # and a fork only appends — the seeds stay valid in children
        dup._interval_seeds = self._interval_seeds
        return dup
