"""Span tracer for the round loop, exporting Chrome trace-event JSON.

The seam gap (docs/PERF_NOTES.md: raw device kernel ~147k states/s vs.
the integrated pipeline's hundreds) can only be attacked with per-phase
attribution, so the tracer records explicit begin/end **spans** around
every seam of the hybrid round loop — host exec, pack, transfer_up,
device round, transfer_down, bridge lift, ``decide_batch`` solve,
harvest, triage, module dispatch, static-pass stages — plus instant
**marks** for robustness incidents (retry, degrade, breaker open,
checkpoint, quarantine, injected fault).

Model (Chrome trace-event format, Perfetto / chrome://tracing loadable):

* **pid** = job id (0 for a single-tenant analysis and for shared
  device work) — jobs render as process rows;
* **tid** = phase row name (``round``, ``host``, ``pack``, ``device``,
  ``solve``, ``incident``, ...) — phases render as thread rows;
* phase spans are ``ph: "X"`` complete events (ts/dur in microseconds);
* marks are ``ph: "i"`` instant events (``dur`` kept at 0 so every
  event carries the full ``ph/ts/dur/pid/tid/name`` key set);
* rows are named via ``ph: "M"`` metadata events at export.

Rounds are *cut* spans: :meth:`Tracer.cut` closes the previous span on
a track and opens the next, so the round span survives the loop body's
many ``continue``/early-return paths without a try/finally around 200
lines of backend code; any span still open is closed at export.

The tracer is **disabled by default** — ``myth analyze --trace``,
``myth submit --trace`` and the bench's traced phase enable it.  When
disabled, ``span()`` returns a shared no-op context manager: one
attribute check on the hot path.  The event buffer is a bounded ring
(per-round spans are O(10), so the default capacity holds thousands of
rounds before the oldest drop; drops are counted).
"""

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["Tracer", "TRACER"]

_DEFAULT_CAPACITY = 262144

# event tuples: (kind, name, tid, pid, ts_s, dur_s, args)
_SPAN = "X"
_MARK = "i"


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Bounded ring of spans/marks with Chrome trace-event export."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.enabled = False
        self._capacity = capacity
        self._lock = threading.Lock()
        self._events: List[Tuple[str, str, str, int, float, float, dict]] = []
        self._dropped = 0
        self._epoch = time.perf_counter()
        # open "cut" spans, keyed by (track tid, pid, thread ident) so
        # concurrent job threads never close each other's rounds
        self._cuts: Dict[Tuple[str, int, int], Tuple[str, float, dict]] = {}

    # -- lifecycle ----------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None:
                self._capacity = capacity
            if not self.enabled:
                self._epoch = time.perf_counter()
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._cuts.clear()
            self._dropped = 0
            self._epoch = time.perf_counter()

    @property
    def dropped(self) -> int:
        return self._dropped

    # -- recording ----------------------------------------------------

    def _push(self, event) -> None:
        with self._lock:
            self._events.append(event)
            if len(self._events) > self._capacity:
                overflow = len(self._events) - self._capacity
                del self._events[:overflow]
                self._dropped += overflow

    def span(self, name: str, tid: Optional[str] = None, pid: int = 0, **args):
        """Context manager recording a complete event on exit."""
        if not self.enabled:
            return _NULL_SPAN
        return self._live_span(name, tid or name, pid, args)

    @contextmanager
    def _live_span(
        self, name: str, tid: str, pid: int, args: dict
    ) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._push((_SPAN, name, tid, pid, t0, t1 - t0, args))

    def begin(self, name: str, tid: Optional[str] = None, pid: int = 0, **args):
        """Explicit begin; pair with :meth:`end`. Returns an opaque
        token (or None when disabled)."""
        if not self.enabled:
            return None
        return (name, tid or name, pid, time.perf_counter(), args)

    def end(self, token) -> None:
        if token is None or not self.enabled:
            return
        name, tid, pid, t0, args = token
        self._push((_SPAN, name, tid, pid, t0, time.perf_counter() - t0, args))

    def mark(self, name: str, tid: str = "incident", pid: int = 0, **args):
        """Instant event (robustness incidents, fault injections)."""
        if not self.enabled:
            return
        self._push((_MARK, name, tid, pid, time.perf_counter(), 0.0, args))

    def cut(self, track: str, name: str, pid: int = 0, **args) -> None:
        """Close the open span on ``track`` (if any) and open ``name``.

        Sequential spans (rounds) on loop bodies full of ``continue``:
        call at the top of each iteration and :meth:`end_cut` after the
        loop; early returns are healed at export time."""
        if not self.enabled:
            return
        now = time.perf_counter()
        key = (track, pid, threading.get_ident())
        with self._lock:
            open_cut = self._cuts.pop(key, None)
            if open_cut is not None:
                prev_name, t0, prev_args = open_cut
                self._events.append(
                    (_SPAN, prev_name, track, pid, t0, now - t0, prev_args)
                )
                if len(self._events) > self._capacity:
                    overflow = len(self._events) - self._capacity
                    del self._events[:overflow]
                    self._dropped += overflow
            self._cuts[key] = (name, now, args)

    def end_cut(self, track: str, pid: int = 0) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        key = (track, pid, threading.get_ident())
        with self._lock:
            open_cut = self._cuts.pop(key, None)
            if open_cut is not None:
                name, t0, args = open_cut
                self._events.append((_SPAN, name, track, pid, t0, now - t0, args))

    def _flush_cuts(self) -> None:
        """Close every still-open cut (early-returned round loops)."""
        now = time.perf_counter()
        with self._lock:
            for (track, pid, _tident), (name, t0, args) in self._cuts.items():
                self._events.append((_SPAN, name, track, pid, t0, now - t0, args))
            self._cuts.clear()

    # -- export -------------------------------------------------------

    def cursor(self) -> int:
        """Monotonic position for :meth:`events_since` (per-job slices).

        Approximate under ring overflow: the cursor is an index into the
        retained window adjusted by the drop count."""
        with self._lock:
            return self._dropped + len(self._events)

    def raw_events(self, since: int = 0):
        self._flush_cuts()
        with self._lock:
            start = max(0, since - self._dropped)
            return list(self._events[start:])

    def chrome_events(
        self, since: int = 0, pids: Optional[set] = None
    ) -> List[Dict[str, Any]]:
        """Trace-event dicts; every event carries ph/ts/dur/pid/tid/name."""
        raw = self.raw_events(since)
        if pids is not None:
            raw = [e for e in raw if e[3] in pids]
        # stable small ints per (pid, tid-name) row + metadata naming
        tid_ids: Dict[Tuple[int, str], int] = {}
        out: List[Dict[str, Any]] = []
        epoch = self._epoch
        for kind, name, tid, pid, ts, dur, args in raw:
            row = tid_ids.get((pid, tid))
            if row is None:
                row = len([k for k in tid_ids if k[0] == pid]) + 1
                tid_ids[(pid, tid)] = row
            event: Dict[str, Any] = {
                "ph": kind,
                "name": name,
                "cat": tid,
                "ts": round((ts - epoch) * 1e6, 1),
                "dur": round(dur * 1e6, 1),
                "pid": pid,
                "tid": row,
            }
            if kind == _MARK:
                event["s"] = "t"
            if args:
                event["args"] = args
            out.append(event)
        meta: List[Dict[str, Any]] = []
        for pid in sorted({p for p, _ in tid_ids}):
            meta.append(_meta("process_name", pid, 0,
                              "analysis" if pid == 0 else "job %d" % pid))
        for (pid, tid), row in sorted(tid_ids.items(), key=lambda kv: kv[1]):
            meta.append(_meta("thread_name", pid, row, tid))
        return meta + out

    def chrome_trace(
        self, since: int = 0, pids: Optional[set] = None
    ) -> Dict[str, Any]:
        return {
            "traceEvents": self.chrome_events(since, pids),
            "displayTimeUnit": "ms",
        }

    def export(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the event count."""
        trace = self.chrome_trace()
        with open(path, "w") as fh:
            json.dump(trace, fh)
        return len(trace["traceEvents"])


def _meta(kind: str, pid: int, tid: int, label: str) -> Dict[str, Any]:
    return {
        "ph": "M",
        "name": kind,
        "ts": 0,
        "dur": 0,
        "pid": pid,
        "tid": tid,
        "args": {"name": label},
    }


TRACER = Tracer()
