"""The program's spans in a traced run (``portbench/spans.py``) and the
seven readers of them: hand-worked contexts, the join of the tracer's
record to the profiler's ranges, a traced CPU run, and on the card the
proof that the program's spans and the kernels share one clock."""

import pytest
import torch

from portbench import run, spans, trace
from portbench.reference import lanes
from portbench.tests.tiny import load, tiny_cell

NAMES = [m["name"] for m in spans.METRICS]

BENCH = [("window", 0.0, 1000.0),
         ("handoff.upload", 0.0, 100.0), ("handoff.round_loop", 100.0, 300.0), ("handoff.download", 300.0, 400.0),
         ("handoff.upload", 500.0, 600.0), ("handoff.round_loop", 600.0, 800.0), ("handoff.download", 800.0, 900.0)]


def sp(sid, name, s, e, parent=0, **args):
    return (name, float(s), float(e), parent, dict(args, id=sid, parent=parent))


# two hand-offs, times in us; the second's pool has no staged upload and it prunes lanes
PROGRAM = [
    sp(1, "transfer.up.parts", 10, 40), sp(2, "transfer.up.stage", 40, 90), sp(3, "transfer.up.launch", 70, 90, 2),
    sp(4, "round_loop.pool", 100, 150), sp(5, "transfer.up.stage", 110, 130, 4),
    sp(6, "fused_super_round", 150, 290, rounds=1, max_rounds=16, launches=48),
    sp(7, "fused.setup", 150, 180, 6), sp(8, "fused.enqueue", 180, 240, 6),
    sp(9, "round_loop.info_fetch", 240, 290, 6, reads=1), sp(10, "round_loop.drain_read", 290, 295, reads=2),
    sp(11, "transfer.down.small", 300, 330), sp(12, "transfer.down.unpack", 330, 335),
    sp(13, "transfer.down.big", 335, 370), sp(14, "transfer.down.unpack", 370, 372),
    sp(15, "transfer.down.pad", 372, 390),
    sp(16, "transfer.up.parts", 510, 530), sp(17, "transfer.up.stage", 530, 560),
    sp(18, "round_loop.pool", 600, 640),
    sp(19, "fused_super_round", 640, 790, rounds=2, max_rounds=16, launches=96),
    sp(20, "fused.setup", 640, 660, 19), sp(21, "fused.enqueue", 660, 700, 19),
    sp(22, "round_loop.info_fetch", 700, 780, 19, reads=1), sp(23, "round_loop.drain_read", 780, 785, reads=2),
    sp(24, "round_loop.pruned_fetch", 785, 790, reads=1),
    sp(25, "transfer.down.small", 800, 820), sp(26, "transfer.down.unpack", 820, 824),
    sp(27, "transfer.down.big", 824, 850), sp(28, "transfer.down.unpack", 850, 851),
    sp(29, "transfer.down.pad", 851, 861),
]

# each by hand: the self time of the named spans in each hand-off, the mean in ms
WANT = {
    "round_loop.pool_ms": (30 + 40) / 2 / 1e3,  # hand-off 0's pool less its staged upload
    "round_loop.setup_ms": (30 + 20) / 2 / 1e3,
    "round_loop.enqueue_ms": (60 + 40) / 2 / 1e3,
    "round_loop.launches_per_round": (48 + 96) / (1 + 2),
    "round_loop.syncs_per_handoff": ((1 + 2) + (1 + 2 + 1)) / 2,
    "transfer.up_host_ms": ((30 + 30 + 20) + (20 + 30)) / 2 / 1e3,  # parts, stage less launch, the pool's stage
    "transfer.down_host_ms": ((5 + 2 + 18) + (4 + 1 + 10)) / 2 / 1e3,
}


def _ctx(program=None, ops=()):
    handoffs = [{"rounds": 1, "seed_rows": 1, "end_rows": 1, "dying": 0, "latency_s": 4e-4, "up_ms": None,
                 "down_ms": None, "loop": (100.0, 300.0)},
                {"rounds": 2, "seed_rows": 1, "end_rows": 1, "dying": 0, "latency_s": 4e-4, "up_ms": None,
                 "down_ms": None, "loop": (600.0, 800.0)}]
    ctx = run.TraceContext(handoffs, list(ops), BENCH, (0.0, 1000.0), lanes.DEFAULT_BATCH_CFG, 100, {})
    if program is not None:
        ctx.program_spans = spans.by_handoff(program, BENCH)
    return ctx


@pytest.mark.parametrize("name", NAMES)
def test_reader_against_hand_worked_value(name):
    assert run._metric_reader(name)(_ctx(PROGRAM)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_without_program_spans_reads_nothing(name):
    reader = run._metric_reader(name)
    assert reader(_ctx()) is None  # a context the benchmark builds today has no program_spans
    assert reader(_ctx([])) is None  # a program that records no spans


def test_spans_are_grouped_by_handoff_and_self_time_excludes_children():
    groups = spans.by_handoff(PROGRAM, BENCH)
    assert [len(g) for g in groups] == [15, 14]
    own = spans.self_us(groups[0])
    assert own[6] == 140 - 30 - 60 - 50 and own[2] == 30 and own[4] == 30


def test_breakdown_names_a_gap_by_the_innermost_program_span():
    ops = [("kernel", 0.0, 200.0), ("kernel", 250.0, 1000.0)]  # idle 200-250, inside fused.enqueue
    assert trace.breakdown(ops, BENCH, 0.0, 1000.0)["idle_gaps"][0][0] == "handoff.round_loop"
    got = spans.breakdown(ops, BENCH, PROGRAM, 0.0, 1000.0)
    assert got["idle_gaps"] == [["fused.enqueue", pytest.approx(50e-6)]]


def test_idle_in_handoffs_counts_what_program_spans_cover():
    ops = [("kernel", 0.0, 200.0), ("kernel", 250.0, 295.0), ("kernel", 297.0, 1000.0)]
    got = spans.idle_in_handoffs(_ctx(PROGRAM, ops))
    # 200-250 lies in fused_super_round; 295-297 between drain_read and transfer.down.small
    assert got["idle_s"] == pytest.approx(52e-6) and got["covered_s"] == pytest.approx(50e-6)
    assert got["share"] == pytest.approx(50 / 52)


def test_collect_joins_the_tracers_record_to_the_profilers_ranges():
    from mythril_tpu_torch.obs.trace import Tracer

    t = Tracer()
    t.enable(profiler=True)
    with t.span("before"):  # recorded, but before the profiler: no range
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("handoff.upload"):
            with t.span("outer", reads=1):
                token = t.begin("inner")
                t.end(token, rounds=2)
            with t.span("before"):
                pass
    got = spans.collect(prof, t.raw_events())
    assert [g[0] for g in got] == ["outer", "inner", "before"]
    outer, inner, before = got
    assert outer[3] == 0 and inner[3] == outer[4]["id"] and before[3] == 0
    assert outer[4]["reads"] == 1 and inner[4]["rounds"] == 2
    assert before[4]["id"] == 4  # the second "before", not the first
    assert outer[1] <= inner[1] <= inner[2] <= outer[2] <= before[1]
    _ops, bench = trace.collect(prof)
    up = [s for s in bench if s[0] == "handoff.upload"][0]
    assert up[1] <= outer[1] and before[2] <= up[2]


def test_collections_of_the_older_generations_are_spans():
    import gc

    from mythril_tpu_torch.obs.trace import Tracer

    t = Tracer()
    t.enable()
    recorder = spans._gc_recorder(t)
    gc.callbacks.append(recorder)
    try:
        with t.span("fused.setup"):
            gc.collect(0)
            gc.collect(2)
        gc.collect(1)
    finally:
        gc.callbacks.remove(recorder)
    got = [(name, args) for kind, name, _tid, _pid, _ts, _dur, args in t.raw_events() if kind == "X"]
    collections = [args for name, args in got if name == "gc.collect"]
    setup = [args for name, args in got if name == "fused.setup"][0]
    assert [a["generation"] for a in collections] == [2, 1]
    assert collections[0]["parent"] == setup["id"] and collections[1]["parent"] == 0
    program = [sp(1, "gc.collect", 0, 30, generation=2), sp(2, "gc.collect", 40, 45, generation=1)]
    assert spans.gc_summary(program) == {"collections": 2, "gen2": 1, "seconds": pytest.approx(35e-6),
                                         "longest_s": pytest.approx(30e-6)}


def test_a_traced_cpu_run_reads_the_program_spans(monkeypatch):
    _bench, cell, config, mix = tiny_cell("token.frontier", monkeypatch)
    result, _checks, ctx = spans.run_traced(cell, config, mix, 2**33 + 11, 0.5, "cpu", per_layer=spans.METRICS,
                                            log=lambda m: None)
    assert result["correct"]
    got = result["metrics"]
    # the CPU path runs the plain twins: no card set-up, enqueue or launches
    assert set(got) == {"round_loop.pool_ms", "round_loop.syncs_per_handoff", "transfer.up_host_ms",
                        "transfer.down_host_ms"}
    assert got["round_loop.syncs_per_handoff"]["value"] >= 3
    assert len(ctx.program_spans) == len(ctx.handoffs) and all(ctx.program_spans)
    assert result["idle_in_handoffs"]["share"] > 0.5
    assert set(result["gc"]) == {"collections", "gen2", "seconds", "longest_s"}


@pytest.mark.card
def test_program_spans_share_the_kernels_clock_on_the_card(card):
    _bench, cell, config, mix = load("token.frontier")
    result, _checks, ctx = spans.run_traced(cell, config, mix, 2**35 + 3, 1.0, "cuda", per_layer=spans.METRICS,
                                            log=lambda m: None)
    assert result["correct"] and set(NAMES) <= set(result["metrics"])
    phases = [s for s in ctx.spans if s[0].startswith("handoff.")]
    assert len(phases) == 3 * len(ctx.program_spans)
    for k, group in enumerate(ctx.program_spans):
        mine = phases[3 * k: 3 * k + 3]
        lo, hi = mine[0][1], mine[2][2]
        k4_end = max(e for n, s, e in ctx.ops if "epilogue_kernel" in n and lo <= s <= hi)
        for name, s, e, _parent, _args in group:
            assert any(p[1] - 10 <= s and e <= p[2] + 10 for p in mine), (k, name, s, e, mine)
            if name == "round_loop.info_fetch":
                assert e >= k4_end, (k, s, e, k4_end)
