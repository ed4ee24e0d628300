"""Detection module interface.

Parity surface: mythril/analysis/module/base.py. Two module kinds:
CALLBACK modules hook opcodes and accumulate issues during execution
(fast); POST modules scan the finished statespace. The declarative
ProbeModule base most built-ins use lives in probe.py."""

import logging
from abc import ABC, abstractmethod
from enum import Enum
from typing import FrozenSet, Iterable, List, Optional, Set

from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState
from mythril_tpu_torch.support.events import ISSUE_BUS

log = logging.getLogger(__name__)


class EntryPoint(Enum):
    POST = 1
    CALLBACK = 2


class IssueList(List[Issue]):
    """A module's ``issues`` list that publishes every NEW finding to
    the issue event bus (support/events.py) the moment a hook appends
    it — the seam streaming partial results hangs off. Only append
    paths publish: wrapping an existing list (reset, the service's
    name-filtered harvest reassigning the kept remainder) republishes
    nothing, so an issue is announced exactly once."""

    def append(self, issue: Issue) -> None:
        super().append(issue)
        ISSUE_BUS.publish(getattr(issue, "contract", ""), issue)

    def extend(self, issues: Iterable[Issue]) -> None:
        for issue in issues:
            self.append(issue)

    def __iadd__(self, issues: Iterable[Issue]) -> "IssueList":
        self.extend(issues)
        return self


class DetectionModule(ABC):
    """One vulnerability detector.

    Class-level declarations: name, swc_id, description, entry_point, and
    the pre_hooks/post_hooks opcode lists (a trailing * is a prefix
    wildcard, expanded by module/util.py)."""

    name = "Detection Module Name / Title"
    swc_id = "SWC-000"
    description = "Detection module description"
    entry_point: EntryPoint = EntryPoint.CALLBACK
    pre_hooks: List[str] = []
    post_hooks: List[str] = []
    # opcodes whose pre-hook this module can replay over a lifted term
    # tape (batch-aware mode): when EVERY module hooking an opcode lists
    # it here, the device retires the opcode instead of freeze-trapping,
    # and the bridge calls replay_tape_node at lift time
    tape_replay_hooks: FrozenSet[str] = frozenset()

    def __init__(self) -> None:
        self._issues: IssueList = IssueList()
        # reported-site dedup keys: (contract name, byte address). The
        # contract component is load-bearing for the multi-tenant
        # analysis service: modules are process singletons, and a bare
        # address would collide across concurrently running jobs (each
        # job analyzes under a unique contract name)
        self.cache: Set[tuple] = set()

    @property
    def issues(self) -> IssueList:
        return self._issues

    @issues.setter
    def issues(self, value: Iterable[Issue]) -> None:
        # every reassignment (reset_module, the service harvest's
        # ``module.issues = keep``) stays a publishing IssueList; the
        # wrap itself publishes nothing (see IssueList)
        self._issues = IssueList(value)

    def reset_module(self):
        self.issues = []
        self.cache = set()

    def execute(self, target: GlobalState) -> Optional[List[Issue]]:
        """Hook entry point; delegates to the subclass's _execute."""
        log.debug("Entering analysis module: %s", type(self).__name__)
        result = self._execute(target)
        log.debug("Exiting analysis module: %s", type(self).__name__)
        return result

    @abstractmethod
    def _execute(self, target) -> Optional[List[Issue]]:
        """Subclass detection logic."""

    def __repr__(self) -> str:
        return (
            "<DetectionModule name={0.name} swc_id={0.swc_id} "
            "pre_hooks={0.pre_hooks} post_hooks={0.post_hooks} "
            "description={0.description}>"
        ).format(self)
