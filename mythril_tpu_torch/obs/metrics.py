"""Low-overhead metrics registry: named counters / gauges / histograms.

One process-wide :data:`REGISTRY` unifies the telemetry that previously
lived in scattered per-module ``stats()`` dicts (solver cache, static
pass, taint, hook gating, scheduler, checkpoint journal, retry
counters).  The old dict accessors remain as thin views; the registry is
the single snapshot/reset surface and the source for the Prometheus
text exposition served by the service ``metrics`` op (service/api.py).

Design constraints:

* **near-zero cost when disabled** — ``MYTHRIL_TPU_OBS=0`` turns every
  ``inc``/``set``/``observe`` into a single attribute check and return;
* **thread-safe when enabled** — the service tier finishes jobs from
  worker threads concurrently, so every mutation takes the instrument's
  lock (a lost increment is exactly the bug satellite 2 fixes in the
  scheduler);
* **labels** — instruments are created unlabelled or with a fixed
  ``labelnames`` tuple; ``labels(v1, v2)`` resolves a child series.
  Series are stored per label-value tuple, ``()`` for the bare series;
* **pull collectors** — hot existing stats surfaces (the solver cache's
  ``_stats`` dict lives under its own lock) are exposed via registered
  collector callables instead of rewriting their hot paths.  Collectors
  run at snapshot/render time only.

Metric *names* are registered exclusively in ``obs/catalog.py`` — the
``metric_names`` lint rule (scripts/lint.py) rejects instrument
construction anywhere else and enforces snake_case with a unit suffix
(``_s`` / ``_bytes`` / ``_total``).
"""

import os
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "Sample",
    "enabled",
    "set_enabled",
]

_OBS_ENV = "MYTHRIL_TPU_OBS"

# module-level switch, read on every mutation.  Default ON: the
# acceptance bar is < 5% overhead with everything enabled, and the
# instruments below are per-round / per-batch, never per-instruction.
_ENABLED = os.environ.get(_OBS_ENV, "1") not in ("0", "false", "off")


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Flip the global obs switch (tests; the env path is
    ``MYTHRIL_TPU_OBS=0``)."""
    global _ENABLED
    _ENABLED = bool(on)


# a rendered sample: (name, label kv pairs, value)
Sample = Tuple[str, Tuple[Tuple[str, str], ...], float]


class _Instrument:
    """Base: a named family of series keyed by label-value tuples."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], float] = {}

    def _key(self, labelvalues: Tuple[str, ...]) -> Tuple[str, ...]:
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                "%s: expected %d label values, got %d"
                % (self.name, len(self.labelnames), len(labelvalues))
            )
        return tuple(str(v) for v in labelvalues)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def samples(self) -> List[Sample]:
        with self._lock:
            items = sorted(self._series.items())
        return [
            (self.name, tuple(zip(self.labelnames, key)), value)
            for key, value in items
        ]


class Counter(_Instrument):
    """Monotonic counter.  ``inc()`` adds (default 1.0) to a series."""

    kind = "counter"

    def inc(self, amount: float = 1.0, *labelvalues: str) -> None:
        if not _ENABLED:
            return
        key = self._key(labelvalues)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def labels(self, *labelvalues: str) -> "_BoundCounter":
        return _BoundCounter(self, self._key(labelvalues))

    def value(self, *labelvalues: str) -> float:
        with self._lock:
            return self._series.get(self._key(labelvalues), 0.0)


class _BoundCounter:
    __slots__ = ("_parent", "_key")

    def __init__(self, parent: Counter, key: Tuple[str, ...]):
        self._parent = parent
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        if not _ENABLED:
            return
        p = self._parent
        with p._lock:
            p._series[self._key] = p._series.get(self._key, 0.0) + amount


class Gauge(_Instrument):
    """Last-write-wins value (queue depth, resident lanes, breaker state)."""

    kind = "gauge"

    def set(self, value: float, *labelvalues: str) -> None:
        if not _ENABLED:
            return
        key = self._key(labelvalues)
        with self._lock:
            self._series[key] = float(value)

    def max(self, value: float, *labelvalues: str) -> None:
        """Keep the running maximum (high-water marks)."""
        if not _ENABLED:
            return
        key = self._key(labelvalues)
        with self._lock:
            cur = self._series.get(key)
            if cur is None or value > cur:
                self._series[key] = float(value)

    def value(self, *labelvalues: str) -> float:
        with self._lock:
            return self._series.get(self._key(labelvalues), 0.0)


# default buckets suit round-loop phases: 100 µs .. ~10 s
_DEFAULT_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
)

# raw observations kept per series for percentile queries (bench.py
# round_phase_p50_ms / p95_ms); bounded so a long service run cannot
# grow without limit
_RESERVOIR_CAP = 4096


class Histogram(_Instrument):
    """Cumulative-bucket histogram plus a bounded raw-value reservoir.

    Prometheus exposition renders ``<name>_bucket{le=...}``, ``_sum``
    and ``_count``; :meth:`percentile` serves the bench protocol from
    the reservoir (exact for <= _RESERVOIR_CAP observations, a recent
    window beyond that).
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = _DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        # per series: [bucket counts..., +Inf count], sum, raw deque
        self._hseries: Dict[Tuple[str, ...], list] = {}

    def observe(self, value: float, *labelvalues: str) -> None:
        if not _ENABLED:
            return
        key = self._key(labelvalues)
        with self._lock:
            entry = self._hseries.get(key)
            if entry is None:
                entry = [[0] * (len(self.buckets) + 1), 0.0, []]
                self._hseries[key] = entry
            counts, _, raw = entry
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            entry[1] += value
            raw.append(value)
            if len(raw) > _RESERVOIR_CAP:
                del raw[: len(raw) - _RESERVOIR_CAP]

    def reset(self) -> None:
        with self._lock:
            self._hseries.clear()

    def percentile(self, q: float, *labelvalues: str) -> Optional[float]:
        """q in [0, 100]; None when the series has no observations."""
        key = self._key(labelvalues)
        with self._lock:
            entry = self._hseries.get(key)
            raw = sorted(entry[2]) if entry else []
        if not raw:
            return None
        idx = min(len(raw) - 1, max(0, int(round(q / 100.0 * (len(raw) - 1)))))
        return raw[idx]

    def count(self, *labelvalues: str) -> int:
        key = self._key(labelvalues)
        with self._lock:
            entry = self._hseries.get(key)
            return sum(entry[0]) if entry else 0

    def series_labelvalues(self) -> List[Tuple[str, ...]]:
        with self._lock:
            return sorted(self._hseries.keys())

    def samples(self) -> List[Sample]:
        out: List[Sample] = []
        with self._lock:
            items = sorted(self._hseries.items())
        for key, (counts, total, _raw) in items:
            base = tuple(zip(self.labelnames, key))
            cum = 0
            for i, edge in enumerate(self.buckets):
                cum += counts[i]
                out.append(
                    (self.name + "_bucket", base + (("le", repr(edge)),), cum)
                )
            cum += counts[-1]
            out.append((self.name + "_bucket", base + (("le", "+Inf"),), cum))
            out.append((self.name + "_sum", base, total))
            out.append((self.name + "_count", base, cum))
        return out


class MetricsRegistry:
    """Process-wide instrument registry + keyed pull collectors."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: "Dict[str, _Instrument]" = {}
        # keyed slots so re-registering (a new AnalysisService instance,
        # a test fixture) replaces rather than duplicates samples
        self._collectors: Dict[str, Callable[[], Iterable[Sample]]] = {}

    def _register(self, inst: _Instrument) -> _Instrument:
        with self._lock:
            existing = self._instruments.get(inst.name)
            if existing is not None:
                if type(existing) is not type(inst):
                    raise ValueError(
                        "metric %r re-registered with a different kind"
                        % inst.name
                    )
                return existing
            self._instruments[inst.name] = inst
            return inst

    def counter(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Counter:
        return self._register(Counter(name, help, labelnames))  # type: ignore[return-value]

    def gauge(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Gauge:
        return self._register(Gauge(name, help, labelnames))  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = _DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._register(Histogram(name, help, labelnames, buckets))  # type: ignore[return-value]

    def register_collector(
        self, slot: str, fn: Callable[[], Iterable[Sample]]
    ) -> None:
        """Install a pull collector under ``slot`` (replaces any prior)."""
        with self._lock:
            self._collectors[slot] = fn

    def unregister_collector(self, slot: str) -> None:
        with self._lock:
            self._collectors.pop(slot, None)

    def _collected(self) -> List[Sample]:
        with self._lock:
            fns = list(self._collectors.values())
        out: List[Sample] = []
        for fn in fns:
            try:
                out.extend(fn())
            except Exception:  # noqa: swallow - a broken collector must
                # not take down the metrics endpoint; its samples are
                # simply absent from this scrape
                continue
        return out

    def snapshot(self) -> Dict[str, float]:
        """Flat unified view: ``name{label="v",...} -> value``.

        The single read surface the scattered ``stats()`` dicts unify
        behind; includes both direct instruments and pull collectors.
        """
        out: Dict[str, float] = {}
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            for name, labels, value in inst.samples():
                out[_flat_key(name, labels)] = value
        for name, labels, value in self._collected():
            out[_flat_key(name, labels)] = value
        return out

    def reset(self) -> None:
        """Zero every direct instrument (collectors own their state)."""
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            inst.reset()

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            instruments = sorted(
                self._instruments.values(), key=lambda i: i.name
            )
        seen_names = set()
        for inst in instruments:
            lines.append("# HELP %s %s" % (inst.name, inst.help))
            lines.append("# TYPE %s %s" % (inst.name, inst.kind))
            seen_names.add(inst.name)
            for name, labels, value in inst.samples():
                lines.append(_prom_line(name, labels, value))
        collected = self._collected()
        for name, labels, value in collected:
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if base.endswith(suffix):
                    base = base[: -len(suffix)]
            if base not in seen_names:
                seen_names.add(base)
                lines.append("# TYPE %s untyped" % base)
            lines.append(_prom_line(name, labels, value))
        return "\n".join(lines) + "\n"


def _flat_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join('%s="%s"' % (k, v) for k, v in labels)
    return "%s{%s}" % (name, inner)


def _prom_line(
    name: str, labels: Tuple[Tuple[str, str], ...], value: float
) -> str:
    if isinstance(value, float) and value == int(value) and abs(value) < 1e15:
        rendered = str(int(value))
    else:
        rendered = repr(float(value))
    return "%s %s" % (_flat_key(name, labels), rendered)


REGISTRY = MetricsRegistry()
