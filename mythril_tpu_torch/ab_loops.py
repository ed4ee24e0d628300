"""A/B of the loops around K1 between two checkouts, on one card.

Each run is a fresh process in one checkout's root: it builds that
checkout's kernels, makes seeded batches at ``DEFAULT_BATCH_CFG`` as
``chip_smoke.py`` does (8 symbolic and 8 concrete seeds), and times,
through that checkout's own entry points:

- the fused super-round, ``megakernel.run_fused`` (16 rounds x 256
  steps, in-loop screen on), stats on and off, on becstress and BECToken;
- one 512-step sync slice on BECToken, ``engine.run_with_stats`` and
  ``engine.run``;
- one sync mesh round, ``mesh.round_impl`` (256 steps, the deal, 8
  shards, every seed in shard 0), on BECToken.

Each item is called once to warm up, then ``--reps`` times: ``wall_ms``
is the host clock from the call to the end of a ``synchronize()`` after
it, ``enqueue_ms`` the host clock until the call returns (the card may
still be running). ``launches`` are the K1 launches (and of those, the
ones with the histogram), K8 and K9 launches of one call, read from the
checkout's counters (null where a checkout has no such counter). Every
item's output (every plane, and the histogram) is hashed; ``main``
fails unless all runs of both checkouts agree. One JSON line per run,
with the card's name and power limit and the ptxas lines of
``step.cu``. The entry points used are the ones both sides of the
change have. Run it from a directory that holds both checkouts, on a
machine with the card, e.g.

    python3 mythril_tpu_torch/ab_loops.py parent_checkout . --order ABBA
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mythril_tpu_torch.ab import ab_main  # noqa: E402  (the script runs from its own directory)

RUN_ONE = r'''
import hashlib, json, os, statistics, subprocess, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke
from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.laser.cuda import _build, batch, engine, inloop_solve, megakernel, mesh

reps, seed = int(sys.argv[1]), int(sys.argv[2])
t0 = time.time()
_build.build_all()
build_s = time.time() - t0
dev, cfg = torch.device("cuda"), batch.DEFAULT_BATCH_CFG
rng = np.random.default_rng(seed)
sym = dict(symbolic_calldata=True, symbolic_storage=True, symbolic_caller=True, symbolic_callvalue=True)


def seeds(n_sym, n_conc):
    specs = [dict(sym) for _ in range(n_sym)]
    for i in range(n_conc):
        cd = int(rng.integers(1, 2**31)).to_bytes(32, "big") + int(rng.integers(0, 6)).to_bytes(32, "big")
        specs.append(dict(calldata=cd + bytes(rng.integers(0, 256, 64, dtype=np.uint8)), caller=0x1000 + i))
    return specs


def bank_for(code):
    return batch.make_code_bank([code], cfg.code_len, host_ops=chip_smoke.ALWAYS_HOST, freeze_errors=True,
                                record_storage_events=True, prune_revert=True, device=dev)


inputs = {}
for name, src in (("becstress", chip_smoke.STRESS_SRC), ("bectoken", open("bench_contracts/bectoken.asm").read())):
    inputs[name] = (bank_for(assemble(src)), batch.build_batch(cfg, seeds(8, 8), device=dev))
COUNTERS = {"K1": "launches", "K1_stats": "stats_launches", "K8": "hist_launches", "K9": "slice_launches"}


def zero_counts():
    for attr in COUNTERS.values():
        if hasattr(engine, attr):
            setattr(engine, attr, 0)


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(fn):
    out = fn()  # warm-up; its output is the one hashed
    torch.cuda.synchronize()
    walls, enqs = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls.append(round((time.perf_counter() - t0) * 1e3, 3))
        enqs.append(round((t1 - t0) * 1e3, 3))
    return {"wall_ms": walls, "enqueue_ms": enqs, "wall_ms_median": statistics.median(walls),
            "enqueue_ms_median": statistics.median(enqs),
            "launches": {k: getattr(engine, a, None) for k, a in COUNTERS.items()}, "digest": digest(out)}


pool = inloop_solve.empty_pool(dev)


def super_round(cb, st, stats):
    fo = megakernel.run_fused(cb, None, st, max_rounds=16, steps_per_round=256, with_stats=stats, with_solve=True,
                              pool=pool, device=dev)
    return (*fo.st, fo.info, fo.pruned_visited, fo.hist)


def slice_with_stats(cb, st):
    out, hist = engine.run_with_stats(cb, None, st, max_steps=512, device=dev)
    return (*out, hist)


def mesh_round(cb, st):
    out, occ = mesh.round_impl(cb, None, st, steps_per_round=256, do_rebalance=True, n_shards=8, device=dev)
    return (*out, occ)


items = {}
for name, (cb, st) in inputs.items():
    for stats in (False, True):
        items[f"super_round/{name}/stats_{'on' if stats else 'off'}"] = measure(lambda: super_round(cb, st, stats))
cb, st = inputs["bectoken"]
items["slice_512/bectoken/stats_on"] = measure(lambda: slice_with_stats(cb, st))
items["slice_512/bectoken/stats_off"] = measure(lambda: tuple(engine.run(cb, None, st, max_steps=512, device=dev)))
items["mesh_round/bectoken/8_shards"] = measure(lambda: mesh_round(cb, st))
log = os.path.join(_build.BUILD_DIR, "step.log")
ptxas = [ln.strip() for ln in open(log) if "registers" in ln or "spill" in ln] if os.path.exists(log) else []
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
print(json.dumps({"gpu": smi, "build_s": round(build_s, 3), "reps": reps, "items": items, "ptxas": ptxas}))
'''


def main(argv=None) -> int:
    def options(ap):
        ap.add_argument("--reps", type=int, default=5)
        ap.add_argument("--seed", type=int, default=20261018)

    return ab_main(__doc__, RUN_ONE, lambda a: (a.reps, a.seed), options, argv)


if __name__ == "__main__":
    sys.exit(main())
