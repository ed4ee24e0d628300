"""The program's own spans in a traced run, and the per-layer metrics
that read them.

The program's tracer (``mythril_tpu_torch.obs.TRACER``), enabled with
``profiler=True``, opens a ``torch.profiler`` range of each span's name,
so the profiler stamps the program's spans with the clock it stamps the
kernels with; the tracer's own record gives each span its id, its
parent (the span open on its thread when it began) and its arguments.
``collect`` joins the two into ``(name, start_us, end_us, parent,
args)`` on the clock and origin of ``trace.collect``; ``by_handoff``
groups them by hand-off, which is what the readers of ``METRICS`` find
as ``ctx.program_spans`` (a reader returns None where a context has
none, as on a program that records no spans).

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs a cell's traced run (``run.run_cell``, its check included) with
the tracer on: the result line carries the cell's per-layer metrics and
``METRICS``, the breakdown names each idle gap by the innermost span
that covers its middle, the benchmark's or the program's, and
``idle_in_handoffs`` gives the card's idle time inside the window's
hand-offs and the share of it that some program span covers. Each
collection of the two older generations of Python's garbage collector
is recorded as a ``gc.collect`` span beside the program's, so that a
collector's pause names itself; ``gc`` sums them over the window.
"""

import argparse
import bisect
import gc
import json
import sys
from unittest import mock

from portbench import trace

LAYER_LOOP = "round loop (laser/cuda/backend._run_device_fused)"
LAYER_TRANSFER = "transfer (laser/cuda/transfer.py, K6/K7)"

# the per-layer metrics that read the program's spans, as BENCHMARK.json entries
METRICS = [
    {"name": "round_loop.pool_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": LAYER_LOOP, "moves": "handoff_p95_ms"},
    {"name": "round_loop.setup_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": LAYER_LOOP, "moves": "handoff_p95_ms"},
    {"name": "round_loop.enqueue_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": LAYER_LOOP, "moves": "handoff_p95_ms"},
    {"name": "round_loop.launches_per_round", "unit": "launches", "better": "lower", "source": "program_counter",
     "layer": LAYER_LOOP, "moves": "steps_per_s"},
    {"name": "round_loop.syncs_per_handoff", "unit": "syncs", "better": "lower", "source": "program_counter",
     "layer": LAYER_LOOP, "moves": "handoff_p95_ms"},
    {"name": "transfer.up_host_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": LAYER_TRANSFER, "moves": "handoff_p95_ms"},
    {"name": "transfer.down_host_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": LAYER_TRANSFER, "moves": "handoff_p95_ms"},
]

# the benchmark's own breakdown, which a traced run here takes the place of
_BENCH_BREAKDOWN = trace.breakdown

# the spans whose ``reads`` argument counts blocking device-to-host reads
SYNC_SPANS = ("round_loop.info_fetch", "round_loop.drain_read", "round_loop.pruned_fetch")


def collect(prof, tracer_events) -> list:
    """The program's spans, ``[(name, start_us, end_us, parent, args)]``
    sorted by start: each profiler range the tracer opened (a host user
    annotation that is not one of the benchmark's spans) with the
    tracer's record of the same span (``args["id"]`` is its id,
    ``parent`` its parent's, 0 for none). The tracer records a span when
    it ends and the profiler only while it runs, so the k-th last range
    of a name is the k-th last span of that name the tracer recorded."""
    raw = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in raw), default=0)
    recorded = {}
    for kind, name, _tid, _pid, ts, _dur, args in tracer_events:
        if kind == "X" and "id" in args:
            recorded.setdefault(name, []).append((ts, args))
    ranges = {}
    for e in raw:
        name = e.name()
        if name in recorded and e.is_user_annotation() and not trace._on_card(e) and not trace._is_span(name):
            ranges.setdefault(name, []).append(((e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3))
    out = []
    for name, rs in ranges.items():
        rs.sort()
        recs = sorted(recorded[name], key=lambda r: r[0])[-len(rs):]
        for (s, e), (_ts, args) in zip(rs[len(rs) - len(recs):], recs):
            out.append((name, s, e, args["parent"], args))
    out.sort(key=lambda sp: sp[1])
    return out


def handoff_bounds(spans) -> list:
    """``(start_us, end_us)`` of each hand-off of the benchmark's spans:
    the start of its ``handoff.upload`` to the end of its
    ``handoff.download``."""
    ups = [s for s in spans if s[0] == "handoff.upload"]
    downs = [s for s in spans if s[0] == "handoff.download"]
    return [(u[1], d[2]) for u, d in zip(ups, downs)]


def by_handoff(program, spans) -> list:
    """The program's spans grouped by hand-off: one list a hand-off, in
    the window's order; a span belongs to the hand-off it starts in."""
    bounds = handoff_bounds(spans)
    starts = [b[0] for b in bounds]
    groups = [[] for _ in bounds]
    for sp in program:
        k = bisect.bisect_right(starts, sp[1]) - 1
        if k >= 0 and sp[1] <= bounds[k][1]:
            groups[k].append(sp)
    return groups


def self_us(group) -> dict:
    """Each span's self time by id: its duration less its children's."""
    own = {sp[4]["id"]: sp[2] - sp[1] for sp in group}
    for sp in group:
        if sp[3] in own:
            own[sp[3]] -= sp[2] - sp[1]
    return own


def groups(ctx):
    """The traced hand-offs' program spans, or None where there are none."""
    got = getattr(ctx, "program_spans", None)
    return got if got and any(got) else None


def self_ms(ctx, names) -> float:
    """Mean over the traced hand-offs of the named spans' self time, in
    ms; None where no hand-off has such a span."""
    got = groups(ctx)
    if got is None or not any(sp[0] in names for g in got for sp in g):
        return None
    total = 0.0
    for g in got:
        own = self_us(g)
        total += sum(own[sp[4]["id"]] for sp in g if sp[0] in names)
    return total / len(got) / 1e3


def breakdown(ops, spans, program, lo, hi, top=10):
    """``trace.breakdown`` with the program's spans beside the
    benchmark's: each idle gap named by the innermost of either."""
    return _BENCH_BREAKDOWN(ops, spans + [sp[:3] for sp in program], lo, hi, top)


def idle_in_handoffs(ctx) -> dict:
    """The card's idle time inside the hand-offs (each hand-off's span
    less the union of device operations), and the part of it that lies
    inside some program span of that hand-off, in seconds."""
    busy = trace.merged([(o[1], o[2]) for o in ctx.ops], float("-inf"), float("inf"))
    starts = [b[0] for b in busy]
    idle = covered = 0.0
    for (lo, hi), g in zip(handoff_bounds(ctx.spans), ctx.program_spans or []):
        gaps, prev = [], lo
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        while i < len(busy) and busy[i][0] < hi:
            s, e = busy[i]
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
            i += 1
        if hi > prev:
            gaps.append((prev, hi))
        inside = trace.merged([(sp[1], sp[2]) for sp in g], lo, hi)
        idle += sum(e - s for s, e in gaps)
        covered += sum(max(0.0, min(e, b) - max(s, a)) for s, e in gaps for a, b in inside)
    return {"idle_s": idle / 1e6, "covered_s": covered / 1e6, "share": covered / idle if idle else None}


def _gc_recorder(tracer):
    """A ``gc.callbacks`` entry that records each collection of
    generation 1 or 2 as a ``gc.collect`` span of ``tracer``."""
    open_ = []

    def record(phase, info):
        if info["generation"] < 1:
            return
        if phase == "start":
            open_.append(tracer.begin("gc.collect", tid="gc", generation=info["generation"]))
        elif open_:
            tracer.end(open_.pop(), collected=info["collected"])

    return record


def gc_summary(program) -> dict:
    """The ``gc.collect`` spans of the window: how many, of which
    generation, their total and longest time in seconds."""
    got = [sp for sp in program if sp[0] == "gc.collect"]
    return {"collections": len(got), "gen2": sum(1 for sp in got if sp[4].get("generation") == 2),
            "seconds": sum(sp[2] - sp[1] for sp in got) / 1e6,
            "longest_s": max((sp[2] - sp[1] for sp in got), default=0.0) / 1e6}


def _tracer():
    from mythril_tpu_torch.obs import TRACER

    return TRACER


def run_traced(cell, config, mix, seed, seconds, device, per_layer=(), log=None):
    """``run.run_cell``'s traced run with the program's tracer on, its
    spans joined to the profiler's trace, handed to the readers as
    ``ctx.program_spans`` and to the breakdown: ``(result, checks,
    ctx)``; the result also carries ``idle_in_handoffs``."""
    from portbench import run

    tracer = _tracer()
    seen = {}
    collect_bench = trace.collect

    def collect_both(prof):
        ops, spans = collect_bench(prof)
        seen["program"] = collect(prof, tracer.raw_events())
        return ops, spans

    class Context(run.TraceContext):
        def __init__(self, handoffs, ops, spans, *rest):
            super().__init__(handoffs, ops, spans, *rest)
            self.program_spans = by_handoff(seen["program"], spans)
            seen["ctx"] = self

    def breakdown_both(ops, spans, lo, hi, top=10):
        return breakdown(ops, spans, seen["program"], lo, hi, top)

    tracer.clear()
    tracer.enable(profiler=True)
    recorder = _gc_recorder(tracer)
    gc.callbacks.append(recorder)
    try:
        with mock.patch.object(trace, "collect", collect_both), \
                mock.patch.object(trace, "breakdown", breakdown_both), \
                mock.patch.object(run, "TraceContext", Context):
            result, checks = run.run_cell(cell, config, mix, seed, seconds, True, device, per_layer=per_layer,
                                          log=log)
    finally:
        gc.callbacks.remove(recorder)
        tracer.disable()
        tracer.clear()
    ctx = seen["ctx"]
    result["idle_in_handoffs"] = idle_in_handoffs(ctx)
    result["gc"] = gc_summary(seen["program"])
    return result, checks, ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a cell's traced run with the program's spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import run, traffic

    bench = run.load_benchmark()
    cell, config = run.load_cell(bench, args.workload)
    if not torch.cuda.is_available():
        run._fail(2, "no CUDA card")
    print(json.dumps({"phase": "card", "name": torch.cuda.get_device_name(0), "smi": run.smi(),
                      "workload": args.workload, "seed": args.seed}), flush=True)
    per_layer = [m for m in bench.get("per_layer", []) if args.workload in m.get("workloads", [args.workload])]
    result, checks, _ctx = run_traced(cell, config, traffic.load_mix(cell["traffic"]), args.seed, args.seconds,
                                      "cuda", per_layer=per_layer + METRICS)
    for c in checks:
        print(f"check {c['name']}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
