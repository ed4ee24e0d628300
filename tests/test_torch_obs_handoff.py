"""The tracer's spans inside the port's device hand-off, on the CPU.

One hand-off is what ``backend.exec_batch`` makes of a packed batch:
``transfer.batch_to_device``, ``backend._run_device_fused`` and
``transfer.batch_to_host``. With the tracer on it records a span for
each part of that work, each linked to the span that was open on its
thread when it began; with the tracer off it records nothing. The card
path's own spans (``fused.setup``, ``fused.enqueue``, the staged
upload's ``transfer.up.stage`` and ``transfer.up.launch``) are not on
the CPU path."""

import os
import threading

import pytest
import torch

from mythril_tpu_torch import obs
from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.laser.cuda import backend, convert, transfer
from mythril_tpu_torch.laser.cuda import batch as pb
from mythril_tpu_torch.laser.cuda import mesh as mesh_lib
from mythril_tpu_torch.obs.trace import _NULL_SPAN, Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(lanes=16, stack_slots=32, memory_bytes=256, calldata_bytes=128, storage_slots=8,
           code_len=512, tape_slots=64, path_slots=16, mem_sym_slots=8, ss_ring=16)
BANK_KW = dict(host_ops=(0x00, 0xF3, 0xFD, 0xFF, 0xFE), freeze_errors=True, record_storage_events=True,
               prune_revert=True)
SYM = dict(symbolic_calldata=True, symbolic_storage=True, symbolic_caller=True, symbolic_callvalue=True)
DOWN = ["transfer.down.small", "transfer.down.unpack", "transfer.down.big", "transfer.down.unpack",
        "transfer.down.pad"]


class _Bridge:
    """What the fused paths read and write on exec_batch's bridge."""

    def __init__(self):
        self.fused_round_info = None
        self.fused_pruned_visited = None
        self.mesh_n_shards = 1

    def spill_chain(self, token, events):
        raise AssertionError("no lane of the test's batch fills its storage ring")


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer in the place of the process's, on the CPU backend."""
    t = Tracer()
    monkeypatch.setattr(obs, "TRACER", t)
    monkeypatch.setattr(backend, "DEVICE", "cpu")
    monkeypatch.setenv("MYTHRIL_TPU_FUSED_STEPS", "32")
    return t


def _bank_and_batch():
    cfg = pb.BatchConfig(**CFG)
    with open(os.path.join(ROOT, "bench_contracts", "token.asm")) as f:
        code = assemble(f.read())
    cb = pb.make_code_bank([code], cfg.code_len, device="cpu", **BANK_KW)
    np_batch = convert.batch_to_numpy(pb.build_batch(cfg, [dict(SYM) for _ in range(4)], device="cpu"))
    return cfg, cb, np_batch


def _handoff(t, cfg, cb, np_batch):
    """One hand-off inside a ``handoff`` span; returns the bridge."""
    bridge = _Bridge()
    with t.span("handoff"):
        st = transfer.batch_to_device(np_batch, cfg, device="cpu")
        out, _hist = backend._run_device_fused(cb, st, cfg, bridge=bridge)
        transfer.batch_to_host(out)
    return bridge


def _spans(t):
    return [(name, args) for kind, name, _tid, _pid, _ts, _dur, args in t.raw_events() if kind == "X"]


def test_a_handoff_records_its_spans_with_their_parents(tracer):
    parts = _bank_and_batch()
    tracer.enable()
    _handoff(tracer, *parts)
    spans = _spans(tracer)
    by_id = {args["id"]: name for name, args in spans}
    parent = {name: by_id.get(args["parent"]) for name, args in spans}
    names = [name for name, _args in sorted(spans, key=lambda s: s[1]["id"])]
    assert names[0] == "handoff" and names[1] == "transfer.up.parts" and names[-5:] == DOWN
    for name in ("round_loop.pool", "fused_super_round", "round_loop.info_fetch", "round_loop.drain_read"):
        assert name in names, name
    assert parent["round_loop.info_fetch"] == "fused_super_round"
    for name in ("transfer.up.parts", "round_loop.pool", "fused_super_round", "round_loop.drain_read", *DOWN):
        assert parent[name] == "handoff", name
    assert parent["handoff"] is None
    # the CPU path runs the plain twins: no staged upload, no card set-up or enqueue
    assert not {"transfer.up.stage", "transfer.up.launch", "fused.setup", "fused.enqueue"} & set(names)
    sr = [args for name, args in spans if name == "fused_super_round"]
    assert sr and all(a["rounds"] >= 1 and a["launches"] == 0 and a["max_rounds"] >= a["rounds"] for a in sr)
    assert all(a["steps_per_round"] == 32 for a in sr)
    reads = {name: args["reads"] for name, args in spans if "reads" in args}
    assert reads["round_loop.info_fetch"] == 1 and reads["round_loop.drain_read"] == 2


def test_with_the_tracer_off_a_handoff_records_nothing(tracer):
    assert tracer.span("x") is _NULL_SPAN and tracer.begin("x") is None
    _handoff(tracer, *_bank_and_batch())
    assert tracer.raw_events() == [] and tracer.chrome_events() == []


def _fused_mesh(cb, st, bridge):
    return backend._run_mesh_fused(mesh_lib.make_mesh(2, device="cpu"), 2, cb, pb.default_env(), st,
                                   bridge=bridge)


@pytest.mark.parametrize("path", ["single", "mesh"])
def test_neither_fused_path_cuts_rounds_or_keeps_a_host_wall(tracer, path):
    cfg, cb, np_batch = _bank_and_batch()
    tracer.enable()
    st = transfer.batch_to_device(np_batch, cfg, device="cpu")
    bridge = _Bridge()
    if path == "single":
        backend._run_device_fused(cb, st, cfg, bridge=bridge)
    else:
        _fused_mesh(cb, st, bridge)
    names = [name for name, _args in _spans(tracer)]
    assert "fused_round" not in names and "device_round_iter" not in names
    assert "fused_super_round" in names and "round_loop.pool" in names
    assert bridge.fused_round_info["rounds"] >= 1 and "device_wall_s" not in bridge.fused_round_info


def test_threads_keep_their_own_parent_stacks():
    t = Tracer()
    t.enable()
    a_open, b_done = threading.Event(), threading.Event()

    def a():
        with t.span("a1"):
            a_open.set()
            b_done.wait(10)
            token = t.begin("a2")
            t.end(token)

    def b():
        a_open.wait(10)
        token = t.begin("b1")
        with t.span("b2"):
            pass
        t.end(token, n=3)
        b_done.set()

    threads = [threading.Thread(target=a), threading.Thread(target=b)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    args = {name: a for name, a in _spans(t)}
    assert args["a1"]["parent"] == 0 and args["b1"]["parent"] == 0
    assert args["a2"]["parent"] == args["a1"]["id"]
    assert args["b2"]["parent"] == args["b1"]["id"]
    assert args["b1"]["n"] == 3
    assert len({a["id"] for a in args.values()}) == 4


def test_profiler_mirror_stamps_spans_on_the_profilers_clock():
    t = Tracer()
    t.enable(profiler=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("outer"):
            token = t.begin("inner")
            t.end(token)
        token = t.begin("left_open")
        t.disable()
        t.end(token)  # a span ended after the tracer went off still closes its range
    got = {e.name(): (e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if e.name() in ("outer", "inner", "left_open")}
    assert set(got) == {"outer", "inner", "left_open"}
    assert got["outer"][0] <= got["inner"][0] <= got["inner"][1] <= got["outer"][1]
    assert [name for name, _args in _spans(t)] == ["inner", "outer"]
    assert t._open.ids == []
    t.enable()  # without the mirror again
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("plain"):
            pass
    assert "plain" not in {e.name() for e in prof.profiler.kineto_results.events()}
