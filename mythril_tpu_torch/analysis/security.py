"""Firing detection modules.

Parity surface: mythril/analysis/security.py — POST modules scan the
finished statespace; CALLBACK modules already accumulated issues through
their hooks and are drained (then reset) here."""

import logging
import time
from typing import List, Optional

from mythril_tpu_torch import obs
from mythril_tpu_torch.obs import catalog as _cat
from mythril_tpu_torch.analysis.module.base import EntryPoint
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.analysis.module.util import reset_callback_modules
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.support.events import ISSUE_BUS

log = logging.getLogger(__name__)


def retrieve_callback_issues(white_list: Optional[List[str]] = None) -> List[Issue]:
    """Drain (and reset) the callback modules' accumulated issues."""
    collected: List[Issue] = []
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.CALLBACK, white_list=white_list
    ):
        log.debug("Retrieving results for %s", module.name)
        collected.extend(module.issues)
    reset_callback_modules(module_names=white_list)
    return collected


def fire_lasers(statespace, white_list: Optional[List[str]] = None) -> List[Issue]:
    """POST modules over the statespace, then the callback harvest."""
    log.info("Starting analysis")
    collected: List[Issue] = []
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.POST, white_list=white_list
    ):
        log.info("Executing %s", module.name)
        t0 = time.perf_counter()
        with obs.TRACER.span("module", tid="module", module=module.name):
            collected.extend(module.execute(statespace) or [])
        _cat.MODULE_EXEC_S.inc(time.perf_counter() - t0, module.name)
    collected.extend(retrieve_callback_issues(white_list))
    return collected


def harvest_callback_issues(
    contract_names, white_list: Optional[List[str]] = None
) -> List[Issue]:
    """Drain ONLY the issues attributed to ``contract_names`` from the
    callback modules, leaving everything else in place.

    The multi-tenant analysis service cannot use the reset-based drain
    above: detection modules are process singletons, and a full
    ``reset_callback_modules`` would wipe the accumulated findings (and
    dedup caches) of every OTHER job still in flight. Each service job
    runs under a unique contract name, so name-filtered removal splits
    the singleton state exactly. The module's per-site dedup cache
    entries for these contracts are dropped too — a finished job must
    not leave keys behind in a long-lived process."""
    names = set(contract_names)
    collected: List[Issue] = []
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.CALLBACK, white_list=white_list
    ):
        keep: List[Issue] = []
        for issue in module.issues:
            (collected if issue.contract in names else keep).append(issue)
        module.issues = keep
        module.cache = {
            key
            for key in module.cache
            if not (isinstance(key, tuple) and key and key[0] in names)
        }
    return collected


def fire_lasers_for_job(
    statespace, contract_names, white_list: Optional[List[str]] = None
) -> List[Issue]:
    """The service-side analogue of fire_lasers: POST modules over the
    job's own statespace, then the name-filtered callback harvest."""
    collected: List[Issue] = []
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.POST, white_list=white_list
    ):
        t0 = time.perf_counter()
        with obs.TRACER.span("module", tid="module", module=module.name):
            found = module.execute(statespace) or []
        _cat.MODULE_EXEC_S.inc(time.perf_counter() - t0, module.name)
        # POST modules RETURN findings instead of appending to their
        # issues list, so the streaming seam (module/base.IssueList)
        # never sees them — publish here, per module, so a `watch`
        # stream gets them as each scan finishes rather than at job end
        for issue in found:
            ISSUE_BUS.publish(getattr(issue, "contract", ""), issue)
        collected.extend(found)
    collected.extend(harvest_callback_issues(contract_names, white_list))
    return collected
