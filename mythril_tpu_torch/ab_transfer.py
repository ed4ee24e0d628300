"""A/B of K6 (unpack) and K7 (pack) between two checkouts, on one card.

Each run is a fresh process in one checkout's root: it builds that
checkout's kernels, makes one seeded batch at ``DEFAULT_BATCH_CFG`` shaped
like an analysis's first multi-lane upload (``--live`` lanes with
content, the rest zero, term tapes used to ``--tape-len`` columns), and
times, through that checkout's ``transfer`` module:

- K6: ``unpack`` of the batch's staged upload;
- K7: the two downloads of ``batch_to_host`` (the small planes; the
  bulky ones sliced to the used tape bucket and lane bucket) and a
  ``shard_lanes`` download of 8 lane blocks, as the mesh tiers make.

Each figure is a mean over ``--reps`` calls: ``ms`` between CUDA events
around the calls back to back (the host's time in a call counts where the
card waits for it), ``ms_device`` between events around each call queued
behind a spinning kernel (the device's work alone), ``plain_ms`` the
plain twin's, and for K7 ``library_ms`` (and ``library_ms_device``) one
``torch.cat`` of the same byte views (a tape plane sliced to its used
columns, or a plane cut to its blocks' first lanes, has no flat view, so
its part is flattened inside the call). Every
output is held against the twin's, bit for bit. ``launch_floor_ms_device``
is one ``zero_`` of 16 bytes timed as ``ms_device``: what any launch
costs. One JSON line per run, with the card's name and power limit and
the ptxas lines of ``transfer.cu``. Run it from a directory that holds
both checkouts, on a machine with the card, e.g.

    python3 mythril_tpu_torch/ab_transfer.py parent_checkout . --order ABBA
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from mythril_tpu_torch.ab import ab_main  # noqa: E402  (the script runs from its own directory)

RUN_ONE = r'''
import json, os, subprocess, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
from mythril_tpu_torch.laser.cuda import _build, batch, transfer
from mythril_tpu_torch.laser.cuda.batch import StateBatch

live, tape_len, seed, reps = (int(a) for a in sys.argv[1:5])
t0 = time.time()
_build.build_all()
build_s = time.time() - t0
dev, cfg = torch.device("cuda"), batch.DEFAULT_BATCH_CFG
rng = np.random.default_rng(seed)
nb = {}
for name, (shape, dt) in batch.batch_shapes(cfg).items():
    a = np.zeros(shape, dt)
    sub = (live,) + tuple(shape[1:])
    a[:live] = rng.random(sub) < 0.5 if dt == np.bool_ else rng.integers(0, np.iinfo(dt).max, sub, dtype=dt)
    nb[name] = a
nb["alive"][:] = False
nb["alive"][:live] = True
nb["tape_len"][:live] = tape_len
for f in transfer._TAPE_PLANES:
    nb[f][:, transfer._tape_cols(f, tape_len):] = 0


def sync():
    torch.cuda.synchronize()


def time_ms(fn, spin=False):
    for _ in range(3):
        fn()
    sync()
    if not spin:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        sync()
        return e0.elapsed_time(e1) / reps
    total = 0.0
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        sync()
        torch.cuda._sleep(2_000_000)
        e0.record()
        fn()
        e1.record()
        sync()
        total += e0.elapsed_time(e1)
    return total / reps


def raw(x):
    return x.contiguous().view(torch.uint8)


# K6
parts = transfer.batch_parts(nb, cfg)
staged = transfer.stage(parts, dev)
planes = transfer.unpack(staged)
segs, shipped = transfer._up_spec(parts)
buf = staged.buf[staged.header:] if hasattr(staged, "header") else staged.buf
twin = transfer.unpack_plain(buf, segs)
ok = all(torch.equal(raw(a), raw(b)) for a, b in zip(planes, twin))
ship6 = int(sum(a.nbytes for a in shipped))
full6 = int(sum(s.rows * s.full for s in segs))
k6 = {"shipped_bytes": ship6, "plane_bytes": full6,
      "ms": time_ms(lambda: transfer.unpack(staged)),
      "ms_device": time_ms(lambda: transfer.unpack(staged), spin=True),
      "plain_ms": time_ms(lambda: transfer.unpack_plain(buf, segs)),
      "bound_ms": (ship6 + full6) / 3.35e12 * 1e3}

# K7
st = StateBatch(*planes)
small = tuple(f for f in StateBatch._fields if f not in transfer._SKIP_DOWN and f not in transfer._BIG_DOWN)
t_used, l_used = transfer.down_plan(nb["tape_len"], nb["alive"], cfg.tape_slots)
calls = {"small": (small, None, None, None), "big": (transfer._BIG_DOWN, t_used, l_used, None),
         "shard": (transfer._BIG_DOWN, t_used, None, (8, cfg.lanes // 32))}


def views(fields, t_, l_, shard):
    out = []
    for f in fields:
        x = getattr(st, f)
        if t_ is not None and f in transfer._TAPE_PLANES:
            x = x[:, : transfer._tape_cols(f, t_)]
        if l_ is not None:
            x = x[:l_]
        elif shard is not None:  # a strided view of each block's first lanes
            x = x.reshape((shard[0], x.shape[0] // shard[0]) + tuple(x.shape[1:]))[:, : shard[1]]
        out.append(x.view(torch.uint8))
    return out


k7 = {}
for name, a in calls.items():
    got = transfer.pack(st, *a)
    plain = transfer.pack_plain(st, *a)
    v = views(*a)
    lib = torch.cat([p.reshape(-1) for p in v])
    ok = ok and torch.equal(got, plain) and torch.equal(lib, plain)
    k7[name] = {"bytes": int(got.numel()),
                "ms": time_ms(lambda: transfer.pack(st, *a)),
                "ms_device": time_ms(lambda: transfer.pack(st, *a), spin=True),
                "plain_ms": time_ms(lambda: transfer.pack_plain(st, *a)),
                "library_ms": time_ms(lambda: torch.cat([p.reshape(-1) for p in v])),
                "library_ms_device": time_ms(lambda: torch.cat([p.reshape(-1) for p in v]), spin=True),
                "bound_ms": 2 * got.numel() / 3.35e12 * 1e3}
tiny = torch.empty(16, dtype=torch.uint8, device=dev)
floor = time_ms(lambda: tiny.zero_(), spin=True)  # one launch that moves 16 bytes
log = os.path.join(_build.BUILD_DIR, "transfer.log")
ptxas = [ln.strip() for ln in open(log) if "registers" in ln or "spill" in ln] if os.path.exists(log) else []
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
print(json.dumps({"gpu": smi, "build_s": round(build_s, 3), "t_used": t_used, "l_used": l_used, "K6": k6,
                  "K7": k7, "launch_floor_ms_device": floor, "ptxas": ptxas, "ok": bool(ok)}))
'''


def main(argv=None) -> int:
    def options(ap):
        ap.add_argument("--live", type=int, default=24, help="lanes with content")
        ap.add_argument("--tape-len", type=int, default=20, help="used term-tape columns")
        ap.add_argument("--seed", type=int, default=7)
        ap.add_argument("--reps", type=int, default=20)

    return ab_main(__doc__, RUN_ONE, lambda a: (a.live, a.tape_len, a.seed, a.reps), options, argv)


if __name__ == "__main__":
    sys.exit(main())
