"""The traced run's reduction: device operations and host spans from
``torch.profiler``, the device's busy time over the traced window, and
the breakdown the result line carries.

Times are microseconds from the first event; the benchmark's own spans
(``torch.profiler.record_function`` around each phase of a hand-off)
share the device events' clock.
"""

import bisect
import re


def _is_span(name: str) -> bool:
    return name.startswith("handoff.") or name == "window"


def _on_card(evt) -> bool:
    return "cuda" in str(evt.device_type()).lower()


def collect(prof):
    """``(device_ops, host_spans)``: ``[(name, start_us, end_us)]`` each,
    read from the profiler's raw events; host spans are the benchmark's
    own, named ``handoff.*`` or ``window``. The profiler also shows each
    host span on the device's timeline, as an annotation: those are not
    device operations."""
    raw = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in raw), default=0)
    ops, spans = [], []
    for e in raw:
        name = e.name()
        s, t = (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3
        if _is_span(name):
            if not _on_card(e):
                spans.append((name, s, t))
        elif _on_card(e) and not e.is_user_annotation() and t > s:
            ops.append((name, s, t))
    ops.sort(key=lambda o: o[1])
    spans.sort(key=lambda sp: sp[1])
    return ops, spans


def merged(intervals, lo, hi):
    """The union of ``intervals`` clipped to [lo, hi], as sorted pairs."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Busy:
    """The union of device operations, queried by interval."""

    def __init__(self, ops):
        lo = min((o[1] for o in ops), default=0.0)
        hi = max((o[2] for o in ops), default=0.0)
        self.iv = merged([(o[1], o[2]) for o in ops], lo, hi)
        self.starts = [s for s, _e in self.iv]
        self.cum = [0.0]
        for s, e in self.iv:
            self.cum.append(self.cum[-1] + (e - s))

    def within(self, lo: float, hi: float) -> float:
        i = max(0, bisect.bisect_right(self.starts, lo) - 1)
        total = 0.0
        while i < len(self.iv) and self.iv[i][0] < hi:
            s, e = self.iv[i]
            total += max(0.0, min(e, hi) - max(s, lo))
            i += 1
        return total


def short_name(name: str) -> str:
    """A kernel's name without its signature: ``void f<x>(A, B)`` -> ``f<x>``."""
    name = re.sub(r"^void\s+", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut].strip()[:80]


def breakdown(ops, spans, lo, hi, top=10):
    """The device operations that took most time, and the longest idle
    gaps by the innermost host span that covers each gap's middle."""
    by_name = {}
    for name, s, e in ops:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged([(o[1], o[2]) for o in ops], lo, hi)
    gaps, prev = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = []
    for s, e in gaps:
        mid = (s + e) / 2
        inside = [sp for sp in spans if sp[1] <= mid <= sp[2] and sp[0] != "window"]
        label = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside else "between hand-offs"
        idle.append([label, (e - s) / 1e6])
    return {"device_ops": [[n, v] for n, v in device_ops], "idle_gaps": idle}
