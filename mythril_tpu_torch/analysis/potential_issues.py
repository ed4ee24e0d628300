"""Deferred-solve issue pipeline.

Parity surface: mythril/analysis/potential_issues.py. Detection modules
park cheap "potential" findings (issue text + extra constraints, no
witness) on the state; the engine settles the whole batch at transaction
end, concretizing a witnessing transaction sequence for each and promoting
the survivors onto their detectors. One annotation instance rides each
path, surviving inter-contract calls."""

from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.evm.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState


# When True (set by the tpu-batch backend around lane lifting), deferred
# findings park WITHOUT the collection-time satisfiability screen; the
# backend then triages every parked-unscreened finding of the lifted
# frontier in ONE batched device feasibility call (the screens were ~73 ms
# host solves each, the dominant lift cost on solver-heavy contracts).
# The reference parks unscreened always (its modules append directly),
# so skipping the screen is parity-safe; the batch triage just keeps the
# parked set small the way the eager screen did.
LAZY_SCREEN = False


class PotentialIssuesAnnotation(StateAnnotation):
    def __init__(self):
        self.potential_issues = []

    @property
    def persist_over_calls(self) -> bool:
        return True


def get_potential_issues_annotation(state: GlobalState) -> PotentialIssuesAnnotation:
    """The state's annotation, created on first use."""
    for annotation in state.annotations:
        if isinstance(annotation, PotentialIssuesAnnotation):
            return annotation
    annotation = PotentialIssuesAnnotation()
    state.annotate(annotation)
    return annotation


def check_potential_issues(state: GlobalState) -> None:
    """Transaction end: solve every parked finding against the final path
    condition; promote the satisfiable ones, keep the rest parked."""
    annotation = get_potential_issues_annotation(state)
    unsettled = []
    for potential_issue in annotation.potential_issues:
        try:
            witness = get_transaction_sequence(
                state, state.world_state.constraints + potential_issue.constraints
            )
        except UnsatError:
            unsettled.append(potential_issue)
            continue
        potential_issue.promote(state, witness)
    annotation.potential_issues = unsettled


class PotentialIssue:
    """Issue text + constraints, awaiting a witness."""

    __slots__ = (
        "title",
        "contract",
        "function_name",
        "address",
        "description_head",
        "description_tail",
        "severity",
        "swc_id",
        "bytecode",
        "constraints",
        "detector",
        "screened",
        "screen_key",
    )

    def __init__(
        self,
        contract,
        function_name,
        address,
        swc_id,
        title,
        bytecode,
        detector,
        severity=None,
        description_head="",
        description_tail="",
        constraints=None,
        screened=True,
        screen_key=None,
    ):
        self.title = title
        self.contract = contract
        self.function_name = function_name
        self.address = address
        self.description_head = description_head
        self.description_tail = description_tail
        self.severity = severity
        self.swc_id = swc_id
        self.bytecode = bytecode
        self.constraints = constraints or []
        self.detector = detector
        # False while a LAZY_SCREEN park awaits the backend's batched
        # feasibility triage; settlement treats both values identically.
        # screen_key identifies the finding ACROSS sibling paths (site
        # address + finding-constraint uids) for triage grouping.
        self.screened = screened
        self.screen_key = screen_key

    def promote(self, state: GlobalState, transaction_sequence) -> None:
        """Hand the finished Issue to the detector that parked this."""
        self.detector.cache.add((self.contract, self.address))
        self.detector.issues.append(
            Issue(
                contract=self.contract,
                function_name=self.function_name,
                address=self.address,
                title=self.title,
                bytecode=self.bytecode,
                swc_id=self.swc_id,
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                severity=self.severity,
                description_head=self.description_head,
                description_tail=self.description_tail,
                transaction_sequence=transaction_sequence,
            )
        )
