"""SWC-116/120: control flow driven by predictable block variables.

Parity surface:
mythril/analysis/module/modules/dependence_on_predictable_vars.py — the
post-hooks of COINBASE/GASLIMIT/TIMESTAMP/NUMBER (and of BLOCKHASH when it
was queried with a provably old block number) taint the pushed value; a
JUMPI whose condition carries the taint reports SWC-116 (timestamp) or
SWC-120 (other sources)."""

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.module_helpers import is_prehook
from mythril_tpu_torch.analysis.module.probe import Finding, ProbeModule
from mythril_tpu_torch.analysis.swc_data import TIMESTAMP_DEPENDENCE, WEAK_RANDOMNESS
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.evm.state.annotation import StateAnnotation
from mythril_tpu_torch.smt import ULT, BitVec, symbol_factory

BLOCK_VARIABLE_OPS = ("COINBASE", "GASLIMIT", "TIMESTAMP", "NUMBER")

_TAIL_TEMPLATE = (
    "{} is used to determine a control flow decision. "
    "Note that the values of variables like coinbase, gaslimit, block number and timestamp "
    "are predictable and can be manipulated by a malicious miner. Also keep in mind that "
    "attackers know hashes of earlier blocks. Don't use any of those environment variables "
    "as sources of randomness and be aware that use of these variables introduces "
    "a certain level of trust into miners."
)


class PredictableTaint:
    """Expression annotation: value derives from a predictable source."""

    def __init__(self, source: str) -> None:
        self.source = source


class StaleBlockhashQuery(StateAnnotation):
    """State annotation: BLOCKHASH was called with a past block number."""


class PredictableVariables(ProbeModule):
    name = "Control flow depends on a predictable environment variable"
    swc_id = "{} {}".format(TIMESTAMP_DEPENDENCE, WEAK_RANDOMNESS)
    description = (
        "Check whether control flow decisions are influenced by block.coinbase,"
        "block.gaslimit, block.timestamp or block.number."
    )
    pre_hooks = ["JUMPI", "BLOCKHASH"]
    post_hooks = ["BLOCKHASH"] + list(BLOCK_VARIABLE_OPS)
    # JUMPI reads condition taints only -> replayable at lift time. The
    # taint sources retire on device too: block-var reads are env-leaf
    # tape nodes whose post-hook taint replays over the lifted value
    # (replay_tape_value), and BLOCKHASH's stale-query pre-check folds
    # into the same value replay (the queried number rides as the node's
    # argument).
    tape_replay_hooks = frozenset({"JUMPI", "BLOCKHASH"})
    tape_replay_post_hooks = frozenset(
        {"BLOCKHASH"} | set(BLOCK_VARIABLE_OPS)
    )

    title = "Dependence on predictable environment variable"
    severity = "Low"

    def probe(self, state):
        if is_prehook():
            opcode = state.get_current_instruction()["opcode"]
            if opcode == "JUMPI":
                yield from self._branch_findings(state)
            else:
                self._flag_stale_blockhash(state)
            return
        self._taint_result(state)

    # -- taint sources ---------------------------------------------------

    @staticmethod
    def _flag_stale_blockhash(state) -> None:
        """BLOCKHASH pre-hook: if the queried number can be strictly below
        the current block, the result is a known value."""
        queried = state.mstate.stack[-1]
        current = state.environment.block_number
        past_block = [
            ULT(queried, current),
            ULT(current, symbol_factory.BitVecVal(2 ** 255, 256)),
        ]
        try:
            solver.get_model(state.world_state.constraints + past_block)
            state.annotate(StaleBlockhashQuery())
        except UnsatError:
            pass

    @staticmethod
    def _taint_result(state) -> None:
        """Post-hook: taint the value the block-context op just pushed."""
        opcode = state.environment.code.instruction_list[state.mstate.pc - 1]["opcode"]
        if opcode == "BLOCKHASH":
            if any(state.get_annotations(StaleBlockhashQuery)):
                state.mstate.stack[-1].annotate(
                    PredictableTaint("The block hash of a previous block")
                )
            return
        state.mstate.stack[-1].annotate(
            PredictableTaint("The block.{} environment variable".format(opcode.lower()))
        )

    # -- taint sink --------------------------------------------------------

    def replay_tape_value(self, origin, opcode: str, value, arg):
        """Batch-aware taint sources: the post-hook taints replay over
        the lifted env-leaf value; BLOCKHASH folds its stale-query
        pre-check in (the queried number is the node's argument, the
        origin carries the constraints in force at the read).

        One accepted divergence from the host: staleness is decided per
        query here, while the host's StaleBlockhashQuery STATE annotation
        is sticky — after one provably-stale query the host taints every
        later BLOCKHASH result on that path. Per-query is the tighter
        reading of SWC-120."""
        if opcode == "BLOCKHASH":
            if arg is None or not self._stale_query(origin, arg):
                return None
            taint = PredictableTaint("The block hash of a previous block")
        else:
            taint = PredictableTaint(
                "The block.{} environment variable".format(opcode.lower())
            )
        return BitVec(
            value.raw, annotations=set(value.annotations) | {taint}
        )

    @staticmethod
    def _stale_query(origin, queried) -> bool:
        current = origin.environment.block_number
        past_block = [
            ULT(queried, current),
            ULT(current, symbol_factory.BitVecVal(2 ** 255, 256)),
        ]
        try:
            solver.get_model(origin.world_state.constraints + past_block)
            return True
        except UnsatError:
            return False

    def _branch_findings(self, state):
        condition = state.mstate.stack[-2]
        for annotation in condition.annotations:
            if not isinstance(annotation, PredictableTaint):
                continue
            swc = (
                TIMESTAMP_DEPENDENCE
                if "timestamp" in annotation.source
                else WEAK_RANDOMNESS
            )
            yield Finding(
                swc_id=swc,
                description_head="A control flow decision is made based on {}.".format(
                    annotation.source
                ),
                description_tail=_TAIL_TEMPLATE.format(annotation.source),
            )


detector = PredictableVariables()
