"""Declarative detector framework.

The reference implements every detection module as a free-standing class
that repeats the same machinery: an address-dedup cache, a solver call
(immediate `get_transaction_sequence` or deferred `PotentialIssue`), and
Issue assembly (mythril/analysis/module/modules/*.py). Here that machinery
lives ONCE: a module is a `ProbeModule` subclass that declares its hook
surface and issue text and emits `Finding`s from `probe()`; the shared
runner turns findings into Issues or PotentialIssues.

Semantics parity notes:
- the dedup cache is keyed on the reported instruction address, exactly as
  the reference modules key theirs;
- a deferred finding is pre-checked with `solver.get_model` (cheap sat
  check on the extended constraints) before being parked as a
  PotentialIssue for tx-end promotion — the reference's EtherThief /
  ArbitraryStorage / ArbitraryDelegateCall / ExternalCalls pattern;
- an immediate finding solves `get_transaction_sequence` on the spot and
  silently drops on UnsatError — the reference's Exceptions / TxOrigin /
  Suicide pattern.
"""

import logging
from copy import copy
from typing import Iterable, Optional

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis import potential_issues
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.evm.state.global_state import GlobalState

log = logging.getLogger(__name__)


class Finding:
    """One suspected issue site emitted by a module's probe()."""

    __slots__ = (
        "constraints",
        "address",
        "title",
        "severity",
        "description_head",
        "description_tail",
        "deferred",
        "swc_id",
    )

    def __init__(
        self,
        constraints=None,
        address: Optional[int] = None,
        title: Optional[str] = None,
        severity: Optional[str] = None,
        description_head: Optional[str] = None,
        description_tail: Optional[str] = None,
        deferred: Optional[bool] = None,
        swc_id: Optional[str] = None,
    ):
        self.constraints = list(constraints or [])
        self.address = address
        self.title = title
        self.severity = severity
        self.description_head = description_head
        self.description_tail = description_tail
        self.deferred = deferred
        self.swc_id = swc_id


class ProbeModule(DetectionModule):
    """Hook-driven detector speaking in Findings.

    Subclasses declare: name, swc_id, description, pre_hooks/post_hooks,
    title, severity, description_head, description_tail, deferred — and
    implement probe(state)."""

    entry_point = EntryPoint.CALLBACK
    title = "Issue"
    severity = "Medium"
    description_head = ""
    description_tail = ""
    deferred = False
    # immediate modules may declare finding ALTERNATIVES: stop at the
    # first one that solves (e.g. suicide's to==attacker variant first)
    first_match_only = False

    def probe(self, state: GlobalState) -> Iterable[Finding]:
        """Yield Findings for this state (may be empty)."""
        raise NotImplementedError

    # -- shared runner -------------------------------------------------------

    def site_address(self, state: GlobalState) -> int:
        """The address an issue at this state reports (and dedups on).
        Post-hooked modules see the pc already advanced; they override
        this to point back at the hooked instruction."""
        return state.get_current_instruction()["address"]

    def reset_module(self):
        super().reset_module()
        self._screened_sat = set()

    def _screen_key(self, address, finding):
        """Identity of a deferred finding across sibling paths: site
        address + the hash-consed uids of its extra constraints. Lanes
        lifted from a shared tape prefix produce the SAME condition
        terms, so the key collapses their screens into one."""
        uids = []
        for c in finding.constraints:
            raw = getattr(c, "raw", None)
            uids.append(raw.uid if raw is not None else id(c))
        return (address, tuple(uids))

    def _execute(self, state: GlobalState) -> None:
        contract = state.environment.active_account.contract_name
        if (contract, self.site_address(state)) in self.cache:
            return
        for finding in self.probe(state) or ():
            materialized = self._materialize(state, finding)
            if materialized and self.first_match_only:
                break

    def _materialize(self, state: GlobalState, finding: Finding) -> bool:
        address = finding.address if finding.address is not None else self.site_address(state)
        deferred = self.deferred if finding.deferred is None else finding.deferred
        env = state.environment
        common = dict(
            contract=env.active_account.contract_name,
            function_name=env.active_function_name,
            address=address,
            swc_id=finding.swc_id or self.swc_id,
            title=finding.title or self.title,
            severity=finding.severity or self.severity,
            description_head=finding.description_head or self.description_head,
            description_tail=finding.description_tail or self.description_tail,
            bytecode=env.code.bytecode,
        )
        constraints = copy(state.world_state.constraints)
        constraints += finding.constraints

        if deferred:
            # the collection-time screen only exists to keep provably-dead
            # findings out of the parked set; the authoritative per-path
            # solve happens at transaction-end settlement either way
            # (check_potential_issues). Three tiers, cheapest applicable:
            #   1. first_match_only: eager host solve, always — these
            #      modules need a PER-PATH verdict here (a collapsed or
            #      deferred screen could suppress a satisfiable fallback).
            #   2. LAZY_SCREEN (tpu-batch lift): park unscreened; the
            #      backend triages the lifted frontier's parks in ONE
            #      batched device feasibility call afterwards.
            #   3. sibling-collapse: once ANY path screened this exact
            #      finding satisfiable, later paths park directly.
            lazy = False
            key = None
            if self.first_match_only:
                try:
                    solver.get_model(constraints)
                except UnsatError:
                    return False
            else:
                screened = getattr(self, "_screened_sat", None)
                if screened is None:
                    screened = self._screened_sat = set()
                key = self._screen_key(address, finding)
                if potential_issues.LAZY_SCREEN:
                    lazy = key not in screened
                elif key not in screened:
                    try:
                        solver.get_model(constraints)
                    except UnsatError:
                        return False
                    screened.add(key)
            annotation = get_potential_issues_annotation(state)
            annotation.potential_issues.append(
                PotentialIssue(
                    detector=self,
                    constraints=constraints,
                    screened=not lazy,
                    screen_key=(self, key) if key is not None else None,
                    **common,
                )
            )
            return True

        try:
            transaction_sequence = solver.get_transaction_sequence(state, constraints)
        except UnsatError:
            return False
        self.cache.add((common["contract"], address))
        self.issues.append(
            Issue(
                transaction_sequence=transaction_sequence,
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                **common,
            )
        )
        return True
