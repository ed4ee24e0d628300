"""Where a fused super-round's time goes on the card.

    python3 -m mythril_tpu_torch.profile_fused

Runs ``run_fused(max_rounds=16, steps_per_round=256, with_solve=True)``
at ``DEFAULT_BATCH_CFG`` on becstress and BECToken (16 seed lanes: 8
symbolic, 8 concrete, as chip_smoke.py), once to warm up, then once under
``torch.profiler`` and once timed with the host clock and CUDA events.
Prints one JSON line per contract: host enqueue ms, wall ms to the
``info`` fetch, device ms between events, the profiler's summed kernel
time by kernel name, and the device busy share (kernel time / wall).
Needs a CUDA card; imports nothing of JAX.
"""

import json
import os
import sys
import time

import numpy as np
import torch

from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.laser.cuda import batch, inloop_solve, megakernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALWAYS_HOST = (0x00, 0xF3, 0xFD, 0xFF, 0xFE)
SYM = dict(symbolic_calldata=True, symbolic_storage=True, symbolic_caller=True, symbolic_callvalue=True)


def _inputs(src, dev, seed=1):
    cfg = batch.DEFAULT_BATCH_CFG
    rng = np.random.default_rng(seed)
    specs = [dict(SYM) for _ in range(8)]
    for i in range(8):
        cd = int(rng.integers(1, 2**31)).to_bytes(32, "big") + int(rng.integers(0, 6)).to_bytes(32, "big")
        specs.append(dict(calldata=cd + bytes(rng.integers(0, 256, 64, dtype=np.uint8)), caller=0x1000 + i))
    cb = batch.make_code_bank([assemble(src)], cfg.code_len, host_ops=ALWAYS_HOST, freeze_errors=True,
                              record_storage_events=True, prune_revert=True, device=dev)
    return cb, batch.build_batch(cfg, specs, device=dev)


def _run(cb, st, pool):
    return megakernel.run_fused(cb, None, st, max_rounds=16, steps_per_round=256, with_solve=True, pool=pool)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_fused: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import STRESS_SRC, smi_line

    dev = torch.device("cuda")
    pool = inloop_solve.empty_pool(dev)
    srcs = {"becstress": STRESS_SRC,
            "bectoken": open(os.path.join(ROOT, "bench_contracts", "bectoken.asm")).read()}
    for name, src in srcs.items():
        cb, st = _inputs(src, dev)
        megakernel.decode_info(_run(cb, st, pool).info)  # warm
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = _run(cb, st, pool)
        e1.record()
        t_enq = time.perf_counter()
        stats = megakernel.decode_info(out.info)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tp0 = time.perf_counter()
            megakernel.decode_info(_run(cb, st, pool).info)
            tp1 = time.perf_counter()
        by_name = {}
        for evt in prof.key_averages():
            dt = getattr(evt, "self_device_time_total", None)
            if dt is None:
                dt = getattr(evt, "self_cuda_time_total", 0)
            if dt and evt.device_type is not None and "cuda" in str(evt.device_type).lower():
                by_name[evt.key] = by_name.get(evt.key, 0) + dt / 1e3
        kern_ms = sum(by_name.values())
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
        retired = int(out.st.steps.sum()) + stats.pruned_steps
        print(json.dumps({
            "contract": name, "info": stats._asdict(), "steps_retired": retired,
            "enqueue_ms": (t_enq - t0) * 1e3, "wall_ms": (t1 - t0) * 1e3,
            "device_event_ms": e0.elapsed_time(e1),
            "profiled_wall_ms": (tp1 - tp0) * 1e3,
            "profiled_kernel_ms": kern_ms if by_name else "not measured",
            "device_busy_share": (kern_ms / ((tp1 - tp0) * 1e3)) if by_name else "not measured",
            "kernel_ms_by_name": {k: round(v, 4) for k, v in top.items()},
            "steps_per_s": retired / (t1 - t0),
        }), flush=True)
    print(smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
