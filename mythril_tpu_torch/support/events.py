"""Process-wide issue event bus: the streaming-results seam.

Detection modules accumulate findings on their singleton ``issues``
lists during execution (CALLBACK hooks) or return them from
``execute`` at harvest time (POST scans). Streaming partial results —
the fleet tier's ``watch`` op — needs those findings the moment they
exist, not at job end, so the two publication points
(:class:`mythril_tpu_torch.analysis.module.base.IssueList` appends and
``security.fire_lasers_for_job`` POST returns) publish every issue
here as ``(contract_name, issue)``.

The bus deliberately lives in ``support/`` — the dependency-free bottom
layer — so ``analysis/module/base.py`` can import it without touching
the service package (whose ``__init__`` pulls the scheduler stack) and
the service can subscribe without an import cycle.

Publishing with no subscribers is a cheap no-op: the single-analysis
CLI path pays one empty-list check per issue. Subscriber exceptions
are logged and swallowed — a broken watcher must never fail the
analysis that fired the event.
"""

import logging
import threading
from typing import Any, Callable, List

log = logging.getLogger(__name__)

Listener = Callable[[str, Any], None]


class IssueEventBus:
    """Synchronous fan-out of ``(contract_name, issue)`` events."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._listeners: List[Listener] = []
        self.published = 0

    def subscribe(self, listener: Listener) -> Listener:
        with self._lock:
            if listener not in self._listeners:
                self._listeners.append(listener)
        return listener

    def unsubscribe(self, listener: Listener) -> None:
        with self._lock:
            try:
                self._listeners.remove(listener)
            except ValueError:
                pass

    def publish(self, contract_name: str, issue: Any) -> None:
        with self._lock:
            if not self._listeners:
                return
            listeners = list(self._listeners)
            self.published += 1
        for listener in listeners:
            try:
                listener(contract_name, issue)
            except Exception:
                log.exception("issue-event listener failed")


ISSUE_BUS = IssueEventBus()
