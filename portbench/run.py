"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``portbench/configs/<name>.json``: the
contract, the batch shape, the hand-off's settings) and a traffic mix
(``portbench/traffic/<name>.json``, read by ``portbench/traffic.py``).
The run builds the program's kernels (the first run in a checkout
compiles them into ``mythril_tpu_torch/_build/``), draws the mix's
hand-off batches from ``--seed``, hands each off once to warm up, then
hands them off back to back, one client in a closed loop, for
``--seconds``: a hand-off is the program's upload, fused round loop and
download (``portbench/program.py``), timed from the start of its upload
to its planes on the host. After the window it checks every hand-off
against the plain reference (``portbench/check.py``): its counts, and
for one hand-off of each batch, drawn from the seed, every plane.

With ``--trace 0`` the result line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, each read by its own
reader (``portbench/metrics/<name>.py``) from the profiler's trace of the
window and the benchmark's spans. The last line of standard output is
the result; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.

Needs a CUDA card (exits 2 without one) and imports nothing of JAX or
of the JAX package (exits 3 if the process holds either after the
window).
"""

import time

PROCESS_T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the hand-off's host work is single-threaded
# Python and numpy, and idle pools of CPU threads only add jitter
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

HERE = os.path.dirname(os.path.abspath(__file__))
MASK64 = (1 << 64) - 1
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mythril_tpu")


def _fail(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(bench: dict, workload: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        _fail(2, f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    return cell, config


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _metric_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class TraceContext:
    """What a per-layer metric's reader reads: ``handoffs`` (one dict per
    traced hand-off: ``rounds``, ``seed_rows``, ``end_rows``, ``dying``,
    ``latency_s``, ``up_ms``, ``down_ms``, ``loop`` = the round loop's
    host span in profiler microseconds), ``ops`` (device operations,
    ``(name, start_us, end_us)``), ``spans`` (the benchmark's host spans),
    ``window`` (the traced window's bounds), ``cfg`` (the batch shape),
    ``code_len_used``, ``peaks`` and ``bytes`` (``portbench.bytes``)."""

    def __init__(self, handoffs, ops, spans, window, cfg, code_len_used, peaks):
        from portbench import bytes as bytes_mod
        from portbench import trace

        self.handoffs, self.ops, self.spans, self.window = handoffs, ops, spans, window
        self.cfg, self.code_len_used, self.peaks, self.bytes = cfg, code_len_used, peaks, bytes_mod
        self._busy = trace.Busy(ops)

    def busy_us(self, lo, hi) -> float:
        """Device busy time in [lo, hi]: the union of the device operations."""
        return self._busy.within(lo, hi)

    def kernel_us(self, part: str) -> float:
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.ops if part in n and min(e, hi) > max(s, lo))


def run_cell(cell: dict, config: dict, mix: dict, seed: int, seconds: float, traced: bool, device: str,
             per_layer=(), log=None):
    """One run of a cell on ``device``; returns ``(result, checks)``.
    The tests call it with ``device="cpu"`` and a small configuration."""
    import numpy as np
    import torch

    from portbench import check, program, trace, traffic
    from portbench.peaks import for_card
    from portbench.reference import lanes

    log = log or (lambda msg: print(msg, flush=True))
    on_card = device == "cuda"
    prog = program.Program(config, device)
    log(json.dumps({"phase": "build", "seconds": prog.build_s}))
    batches = traffic.handoff_batches(config, mix, seed)
    seed_rows = [int(b["alive"].sum()) for b in batches]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for b in batches:  # warm-up: every batch once, so nothing builds in the window
        prog.handoff(b)
    sync()
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    setup_s = time.time() - PROCESS_T0

    rng = np.random.default_rng([int(seed) & MASK64, (int(seed) >> 64) & MASK64, 0x5EED])
    records, kept, seen = [], {}, [0] * len(batches)
    span = (lambda name: torch.profiler.record_function(name)) if traced else None
    events = [] if (traced and on_card) else None
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    window_ctx = torch.profiler.record_function("window") if traced else None
    if window_ctx is not None:
        window_ctx.__enter__()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    t_end = t0
    i = 0
    while True:
        bi = i % len(batches)
        clock = []
        host, totals, pv = prog.handoff(batches[bi], span=span, events=events, clock=clock)
        ta, tb = clock[0], clock[-1]
        c = program.counts(host, totals)
        settings = prog.settings(totals)
        records.append({"batch": bi, "latency_s": tb - ta, "counts": c, "settings": settings, "clock": clock})
        seen[bi] += 1
        if rng.random() * seen[bi] < 1.0:  # a hand-off of each batch, each as likely (a reservoir of one)
            kept[bi] = (i, host, pv, c, settings)
        i += 1
        t_end = tb
        if tb >= deadline:
            break
    sync()
    if window_ctx is not None:
        window_ctx.__exit__(None, None, None)
    if prof is not None:
        prof.__exit__(None, None, None)
    window_s = t_end - t0
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    bad = forbidden_modules()
    if bad:
        _fail(3, f"the process holds {bad} after the window")

    lat = np.array([r["latency_s"] for r in records])
    total_steps = sum(r["counts"][0] for r in records)
    phases = np.diff(np.array([r["clock"] for r in records]), axis=1) * 1e3  # upload, round loop, download
    fifths = np.array_split(np.arange(len(records)), 5)
    log(json.dumps({"phase": "window", "handoffs": len(records), "window_s": window_s,
                    "handoff_p50_ms": float(np.percentile(lat, 50) * 1e3),
                    "handoff_p95_ms": float(np.percentile(lat, 95) * 1e3), "samples": len(records),
                    "steps": total_steps, "setup_s": setup_s,
                    "phase_p50_ms": dict(zip(("upload", "round_loop", "download"),
                                             np.median(phases, axis=0).tolist())),
                    "p50_ms_by_fifth": [float(np.median(lat[f]) * 1e3) for f in fifths if len(f)]}))

    result = {"correct": None, "attempted": len(records), "failed": 0, "metrics": {}}
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    result["device"] = {"platform": "gpu" if on_card else "cpu", "kind": name,
                        "count": int(cell.get("chips", 1)), "memory_peak_bytes": memory_peak}
    if not traced:
        result["metrics"] = {
            "steps_per_s": {"value": total_steps / window_s, "unit": "steps/s"},
            "handoff_p95_ms": {"value": float(np.percentile(lat, 95) * 1e3), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    else:
        t_tr = time.time()
        ops, spans = trace.collect(prof)
        log(json.dumps({"phase": "trace", "device_ops": len(ops), "spans": len(spans),
                        "collect_s": time.time() - t_tr}))
        win = [s for s in spans if s[0] == "window"]
        lo, hi = (win[0][1], win[0][2]) if win else (0.0, 0.0)
        loops = [s for s in spans if s[0] == "handoff.round_loop"]
        ev = {}
        if events:
            for k, (nm, e0, e1) in enumerate(events):
                ev.setdefault(nm, []).append(e0.elapsed_time(e1))
        handoffs = []
        for k, r in enumerate(records):
            c = r["counts"]
            handoffs.append({
                "rounds": c[1], "seed_rows": seed_rows[r["batch"]], "end_rows": c[5] + c[2] + c[7],
                "dying": c[2] + c[7], "latency_s": r["latency_s"],
                "up_ms": ev["upload"][k] if ev else None, "down_ms": ev["download"][k] if ev else None,
                "loop": (loops[k][1], loops[k][2]) if k < len(loops) else None,
            })
        ctx = TraceContext(handoffs, ops, spans, (lo, hi), lanes.BatchConfig(**config["batch"]),
                           len(bytes.fromhex(config["runtime_hex"])), for_card(name))
        for m in per_layer:
            v = _metric_reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["device"]["busy_s"] = ctx.busy_us(lo, hi) / 1e6
        result["device"]["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = trace.breakdown(ops, spans, lo, hi)
        log(json.dumps({"phase": "trace", "reduce_s": time.time() - t_tr}))

    # correctness, after the program's state is freed and the peak read:
    # the reference once for each batch under each setting the round loop
    # ran it with; every hand-off's counts against its batch's, and the
    # planes of one hand-off of each batch, drawn from the seed
    if prog.pool_clauses():
        _fail(4, "the round loop's in-loop pool holds clauses; the reference follows only the clause-free pool")
    del prog
    if on_card:
        torch.cuda.empty_cache()
    plane_bytes = info_fields = disagreeing = failed_planes = 0
    for bi, settings in sorted({(r["batch"], r["settings"]) for r in records}):
        t_ref = time.time()
        ref_planes, ref_counts, ref_pv = check.reference_handoff(config, batches[bi], device, settings)
        group = [r for r in records if r["batch"] == bi and r["settings"] == settings]
        bad = sum(1 for r in group if r["counts"] != ref_counts)
        disagreeing += bad
        entry = {"phase": "reference", "seconds": time.time() - t_ref, "batch": bi,
                 "settings": dict(zip(program.SETTING_NAMES, settings)), "handoffs": len(group),
                 "handoffs_disagreeing": bad, "counts": dict(zip(program.COUNT_NAMES, ref_counts))}
        k_index, k_host, k_pv, k_counts, k_settings = kept[bi]
        if k_settings == settings:
            plane_diff = check.plane_differences(k_host._asdict(), ref_planes)
            cover_diff = check.coverage_differences(k_pv, ref_pv)
            fields = [n for n, a, b in zip(program.COUNT_NAMES, k_counts, ref_counts) if a != b]
            plane_bytes += int(sum(plane_diff.values())) + cover_diff
            info_fields += len(fields)
            failed_planes += int(bool(plane_diff) or cover_diff > 0)
            entry.update({"handoff": k_index, "program_counts": dict(zip(program.COUNT_NAMES, k_counts)),
                          "planes_differing": plane_diff, "coverage_differing": cover_diff})
        log(json.dumps(entry))
    checks = [
        {"name": "plane_bytes_differing", "value": plane_bytes, "limit": 0},
        {"name": "info_fields_differing", "value": info_fields, "limit": 0},
        {"name": "handoffs_disagreeing", "value": disagreeing, "limit": 0},
    ]
    result["correct"] = all(c["value"] <= c["limit"] for c in checks)
    result["failed"] = disagreeing + failed_planes
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_benchmark()
    cell, config = load_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        _fail(2, "no CUDA card: the benchmark measures the card and does not fall back to the CPU")
    if torch.cuda.device_count() < int(cell.get("chips", 1)):
        _fail(2, f"the cell asks for {cell.get('chips', 1)} cards, {torch.cuda.device_count()} present")
    from portbench import traffic

    print(json.dumps({"phase": "card", "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
                      "smi": smi(), "workload": args.workload, "seed": args.seed}), flush=True)
    per_layer = [m for m in bench.get("per_layer", []) if args.workload in m.get("workloads", [args.workload])]
    result, checks = run_cell(cell, config, traffic.load_mix(cell["traffic"]), args.seed, args.seconds,
                              bool(args.trace), "cuda", per_layer=per_layer)
    bad = forbidden_modules()
    if bad:
        _fail(3, f"the process holds {bad}")
    for c in checks:
        print(f"check {c['name']}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
