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
  shards, every seed in shard 0), on BECToken;
- the fused mesh super-round, ``megakernel.run_fused_mesh`` (4 rounds x
  256 steps over 8 shards, screen and stats on, every seed in shard 0),
  on becstress, as ``chip_smoke.py``'s phase 12 runs it;
- one ``mesh.steal_round`` (the fused mesh loop's work-steal) over 8
  shards at ``DEFAULT_BATCH_CFG``, on the 96-lane steal state (shards 0-1
  full of running lanes) and on a gated no-steal state (moved 1, spread
  1), each call on a fresh copy made outside the timed region;
- the deal (K12) over 8 shards on the 128-lane steal state (shards 0-1
  full of running lanes), through ``mesh.rebalance`` and as its kernel
  launch alone on a fresh copy (each checkout's own launch call);
- the CNF decider (K5), ``solver.solve`` at ``SOLVE_FLIPS``, on the
  strategy's warmup batch (8 copies of its one-byte formula, the
  smallest bucket), on 8 instances of the smallest bucket and on 64 of
  the largest, compiled from seeded formulas.

Each item is called once to warm up, then ``--reps`` times: ``wall_ms``
is the host clock from the call to the end of a ``synchronize()`` after
it, ``enqueue_ms`` the host clock until the call returns (the card may
still be running), ``device_ms`` the CUDA events recorded around the
call on its stream (for the steal rounds, the deal and the decider also
``spin_device_ms``, the same queued behind a spinning kernel: the
device's own time).
``launches`` are the K1 launches (and of those, the
ones with the histogram), K8 and K9 launches, the mesh kernels'
counts (``K10``/``K11``: the launches that planned and that moved, or
decided whether to; ``mesh_steal``: launches of the one steal kernel;
``K12``: deals) and K5's
of one call, read from the checkout's counters (null where a checkout
has no such counter). Every
item's output (every plane, and the histogram) is hashed; ``main``
fails unless all runs of both checkouts agree. One JSON line per run,
with the card's name and power limit and the ptxas lines of
``step.cu``, ``mesh.cu`` and ``solve.cu``. The entry points used are the ones both sides of the
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
from mythril_tpu_torch.laser.cuda import _build, batch, engine, inloop_solve, kernels, megakernel, mesh, solver

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
COUNTERS = {"K1": (engine, "launches"), "K1_stats": (engine, "stats_launches"), "K8": (engine, "hist_launches"),
            "K9": (engine, "slice_launches"), "K10": (mesh, "plan_launches"), "K11": (mesh, "steal_launches"),
            "mesh_steal": (mesh, "launches"), "K12": (mesh, "deal_launches"), "K5": (solver, "launches")}


def zero_counts():
    for mod, attr in COUNTERS.values():
        if hasattr(mod, attr):
            setattr(mod, attr, 0)


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def measure(fn, prep=None, spin=False):
    """``fn(prep())`` timed, ``prep`` (inputs made anew) outside the timed
    region; with ``spin`` also ``spin_device_ms``, the events around the
    call queued behind a spinning kernel (the device's own time)."""
    out = fn(prep() if prep else None)  # warm-up; its output is the one hashed
    torch.cuda.synchronize()
    walls, enqs, devs, spun = [], [], [], []
    for k in range(2 * reps if spin else reps):
        a = prep() if prep else None
        torch.cuda.synchronize()
        zero_counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if k >= reps:
            torch.cuda._sleep(2_000_000)
        t0 = time.perf_counter()
        e0.record()
        fn(a)
        e1.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if k >= reps:
            spun.append(round(e0.elapsed_time(e1), 4))
            continue
        walls.append(round((time.perf_counter() - t0) * 1e3, 3))
        enqs.append(round((t1 - t0) * 1e3, 3))
        devs.append(round(e0.elapsed_time(e1), 4))
    rec = {"wall_ms": walls, "enqueue_ms": enqs, "device_ms": devs, "wall_ms_median": statistics.median(walls),
           "enqueue_ms_median": statistics.median(enqs), "device_ms_median": statistics.median(devs),
           "launches": {k: getattr(m, a, None) for k, (m, a) in COUNTERS.items()}, "digest": digest(out)}
    if spin:
        rec.update(spin_device_ms=spun, spin_device_ms_median=statistics.median(spun))
    return rec


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


def mesh_super_round(cb, st):
    fo = megakernel.run_fused_mesh(mesh.make_mesh(8, device=dev), cb, None, st, max_rounds=4, steps_per_round=256,
                                   with_stats=True, with_solve=True, pool=pool)
    return (*fo.st, fo.info, fo.pruned_visited, fo.hist)


def steal_state(running):
    """A batch at cfg over 8 shards whose rows carry their lane index:
    ``running[s]`` running lanes as a dense prefix of shard s."""
    per = cfg.lanes // 8
    st = batch.empty_batch(cfg, device=dev)
    lane = torch.arange(cfg.lanes, dtype=torch.int32, device=dev)
    count = torch.tensor(running, dtype=torch.int32, device=dev).repeat_interleave(per)
    alive = lane % per < count
    visited = torch.zeros_like(st.visited)
    visited[lane.long(), lane.long() % cfg.code_len] = True
    stack = st.stack.clone()
    stack[:, 0] = lane
    return st._replace(alive=alive, status=torch.where(alive, batch.RUNNING, batch.STOPPED).to(torch.int32),
                       pc=lane + 100, steps=lane + 1000, static_pruned=torch.full_like(lane, 7), stack=stack,
                       visited=visited)


def steal_args(st):
    """The inputs of one steal_round: a fresh copy of ``st`` and the loop's arguments on it."""
    def prep():
        s = batch.StateBatch(*(x.clone() for x in st))
        return s, kernels.MeshArgs(s, 8)
    return prep


def steal_round(sa):
    s, a = sa
    mesh.steal_round(a)
    return (*s, a.export_, a.buf_pos, a.sh, a.mctl)


items = {}
for name, (cb, st) in inputs.items():
    for stats in (False, True):
        items[f"super_round/{name}/stats_{'on' if stats else 'off'}"] = measure(lambda _: super_round(cb, st, stats))
cb, st = inputs["bectoken"]
items["slice_512/bectoken/stats_on"] = measure(lambda _: slice_with_stats(cb, st))
items["slice_512/bectoken/stats_off"] = measure(lambda _: tuple(engine.run(cb, None, st, max_steps=512, device=dev)))
items["mesh_round/bectoken/8_shards"] = measure(lambda _: mesh_round(cb, st))
cb, st = inputs["becstress"]
items["mesh_super_round/becstress/stats_on"] = measure(lambda _: mesh_super_round(cb, st))
per = cfg.lanes // 8
for label, running in (("steal_96", [per, per] + [0] * 6), ("no_steal", [per // 2] * 7 + [per // 2 + 1])):
    items[f"steal_round/{label}"] = measure(steal_round, steal_args(steal_state(running)), spin=True)


def deal_prep(st):
    """A fresh copy of ``st`` (and, in a checkout whose K12 launch takes
    a scratch batch and an order buffer, those)."""
    def prep():
        s = batch.StateBatch(*(x.clone() for x in st))
        if hasattr(kernels, "DealScratch"):
            return (s,)
        return s, batch.StateBatch(*(torch.empty_like(x) for x in st)), torch.empty(cfg.lanes, dtype=torch.int32,
                                                                                     device=dev)
    return prep


def deal_launch(a):
    if hasattr(kernels, "DealScratch"):
        order = kernels.launch_mesh_deal(a[0], 8)
    else:
        kernels.launch_mesh_deal(a[0], a[1], 8, a[2])
        order = a[2]
    return (*a[0], order)


deal_state = steal_state([per, per] + [0] * 6)
items["deal/steal_128/rebalance"] = measure(lambda _: tuple(mesh.rebalance(deal_state, 8, device=dev)), spin=True)
items["deal/steal_128/launch"] = measure(deal_launch, deal_prep(deal_state), spin=True)

from mythril_tpu_torch.laser.cuda import backend, convert
from mythril_tpu_torch.smt import Not, Or, UGT, ULT, symbol_factory, terms


def formula_sets(width, n, seed_):
    r = np.random.default_rng(seed_)
    a, b, c = (symbol_factory.BitVecSym(f"ab{width}_{seed_}_{x}", width) for x in "abc")

    def val(v):
        return symbol_factory.BitVecVal(int(v) % (1 << width), width)

    out = []
    for k in range(n):
        extra = [UGT(b, val(r.integers(1 << 30))), b - a == c, Or(a == val(5), b == val(r.integers(1 << 30))),
                 Not(c == val(9)), a & val(0xFF) == val(r.integers(256)), c == val(r.integers(1 << 30))]
        pick = [extra[i] for i in r.choice(len(extra), int(r.integers(1, 4)), replace=False)]
        out.append([t.raw for t in [a + val(k) == b, ULT(a, val(r.integers(1 << 30)))] + pick])
    return out


def solve_ops(insts, bucket):
    lits, nvars, is_input, V = solver._pack_batch(insts, *bucket)
    warm = np.where(rng.random(is_input.shape) < 0.25, rng.choice([-1, 1], is_input.shape), 0)
    warm = np.where(np.arange(V)[None, :] < nvars[:, None], warm, 0).astype(np.int8)
    return convert.solver_operands_to_torch((lits, nvars, is_input, warm), dev)


ladder = solver.shape_ladder()
warm_formula = [terms.bool_eq(terms.bv_var("!warmup", 8), terms.bv_const(1, 8))]
warm_insts = [i for i in solver.compile_cnf_batch([warm_formula] * 8, solver.MAX_VARS, solver.MAX_CLAUSES)]
small = [i for i in solver.compile_cnf_batch(formula_sets(32, 8, seed), solver.MAX_VARS, solver.MAX_CLAUSES)
         if i is not None and i.trivial is None and i.nvars <= ladder[0][0] and i.clause_arr.shape[0] <= ladder[0][1]]
big = [i for i in solver.compile_cnf_batch(formula_sets(192, 64, seed), solver.MAX_VARS, solver.MAX_CLAUSES)
       if i is not None and i.trivial is None and (i.nvars > ladder[-2][0] or i.clause_arr.shape[0] > ladder[-2][1])]
for label, insts, bucket in (("warmup_batch", warm_insts, ladder[0]),
                             ("smallest_bucket_I8", [small[i % len(small)] for i in range(8)], ladder[0]),
                             ("largest_bucket_I64", [big[i % len(big)] for i in range(64)], ladder[-1])):
    ops = solve_ops(insts, bucket)
    items[f"solve/{label}"] = measure(lambda _, ops=ops: solver.solve(*ops, backend.SOLVE_FLIPS, 7, device=dev),
                                      spin=True)
    items[f"solve/{label}"]["shape"] = [int(ops[0].shape[0]), *map(int, bucket)]
    items[f"solve/{label}"]["sweeps_max"] = int(solver.solve(*ops, backend.SOLVE_FLIPS, 7, device=dev)[2].max())
ptxas = {}
for src in ("step", "mesh", "solve"):
    log = os.path.join(_build.BUILD_DIR, f"{src}.log")
    ptxas[src] = [ln.strip() for ln in open(log) if "registers" in ln or "spill" in ln] if os.path.exists(log) else []
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
