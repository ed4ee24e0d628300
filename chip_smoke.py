#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``mythril_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's kernels from ``mythril_tpu_torch/csrc/`` and, in
phases that each print one JSON line:

1. build: nvcc seconds per source, registers/spills, the card's name
   and power limit;
2. kernels against their plain PyTorch twins on the card, bit for bit
   (tolerance 0, everything is integer): K2 keccak on the edge lengths
   and on all-empty batches, K1 for 64 steps on full-width becstress
   and BECToken batches (every plane after every step), then one K1
   launch of 64 steps against the twin's 64 steps ("K1 run"), with 1
   and 8 lane blocks, K3 on seeded random pools (V = 64 and 256) and the
   empty pool, K4 on a batch with mixed alive/REVERT/killed lanes, on an
   order where no row moves, one where every row moves and dying lanes
   that keep their place, and over 8 lane blocks with each flag and gate;
3. the main path at DEFAULT_BATCH_CFG (512 lanes, code_len 8192):
   run_fused(max_rounds=16, steps_per_round=256, with_solve=True) on
   becstress, BECToken and the in-loop demo, with every launch counter
   zeroed just before and read just after (one K1 launch of 256 steps
   per round, no K2 launch: K1 hashes SHA3 itself), no host sync allowed
   inside the super-round (torch's sync debug mode raises on one), and
   each result compared with the twin's fused run on the same inputs;
4. per-kernel times on the card against the twin's and a bound; K1 per
   step and per launch of a round's 256 steps, its floor, and its
   registers and spills, each on a line of its own; an oversized
   cooperative K1 launch must raise KernelError; K3's and K4's registers
   and spills; K3 and K4 timed with their launch arguments built once,
   as the loops launch them; the main path's wall and enqueue per
   contract;
5. K6 unpack / K7 pack against their twins at DEFAULT_BATCH_CFG (full,
   tape-sliced, groups-absent, alive-prefix and bool-bytes batches, the
   last with bytes 0-255 in every bool plane) and the host -> card ->
   host round trip of every plane; K7's shard_lanes downloads (8 lane
   blocks of the bulky and of the small planes), and a table past
   XFER_MAX_SEGS, which must raise KernelError;
6. K5 solve against its twin on CNFs compiled from seeded formulas, on
   every (vars, clauses) bucket at 8 and 64 instances, flips 0/64/4096;
   every SAT row must satisfy its CNF and agree with the flips=0 phase
   (``compare_solve``);
7. the whole analysis, SymExecWrapper(strategy="cuda-batch") +
   fire_lasers, on becstress (2 tx, 60 s) and BECToken (3 tx, 120 s):
   the issue sets must be [101@8] and [101@28, 101@104], with device
   rounds, K1/K4/K6/K7 launched by each analysis, every one of K1-K7
   launched by the two runs (counts zeroed just before each, so the
   strategy's own warmup is part of the run), and no degraded round or
   failed device solve; the first K5 batches of the runs are replayed
   through the twin;
8. the times of K5-K7 against their twins, bounds, the host link and a
   per-plane copy_ sequence; K5's time a sweep at the main path's batch
   and at the largest bucket with 64 instances, at its own block size
   and at 256, 512 and 1024 threads, with its resources per bucket
   (``time_solve_per_sweep``, line ``timing_k5``); K6 and each K7 call also queued behind a
   spinning kernel (ms_device), K7's calls beside torch.cat of the same
   byte views (library_ms), and K6/K7's registers and spills;
9. K8 (the retired-opcode histogram, standalone) against its twin after
   each of 64 forking steps of a full-width BECToken batch; K1's stats
   instance (the histogram folded inside the launch) as one launch of
   those 64 steps against the twin's steps and histogram, on grids of
   the lanes' own size, 1 and 8 blocks, from a histogram seeded near
   2^32 (it must wrap), and a launch the control word stops (it must add
   nothing); the sync slice loop (one K1 launch a slice:
   engine.run_with_stats and engine.run) against the twin's loop for one
   512-step slice at DEFAULT_BATCH_CFG, every plane plus the histogram,
   each call launching one K1 and no K8 or K9; K9 (the quiescence
   read's kernel) against its twin, the whole control word, from fresh,
   running, stopped and spent words with max_steps 0, below, at and
   above t, on running and quiescent batches, and engine.any_running on
   each; run_fused(with_stats=True)
   against the twin on becstress and BECToken, one K1 launch a round and
   no K8, and the super-round's wall and enqueue with stats on and off;
10. the port's CLI on the card, `python -m mythril_tpu_torch analyze
   --strategy cuda-batch --enable-iprof -o json` on becstress (2 tx,
   60 s) in a subprocess: it must report [101@8] and a device opcode
   profile, with K1 (stats instance among them), K3, K4, K6 and K7
   launched in that run and no K8 (counted inside the subprocess from
   just before the CLI starts);
11. BECToken (3 tx, 120 s) with MYTHRIL_TPU_FUSED=off: the sync slice
   loop must run device slices, report [101@28, 101@104] and degrade no
   round; then the times of K8 and K9 through their engine entry points
   (and of each launch alone, its arguments built once: launch_ms);
12. the mesh tiers, 8 lane shards of the one card (64 lanes each):
   the steal kernel (K10's counts and plan and K11's moves, one kernel)
   in each use (occupancy_impl, steal_plan, steal_apply of a given plan,
   the fused loop's steal_round from nonzero counters, and a steal round
   of a stopped loop, which writes nothing) against the twins, at 64,
   160, 512 and 1024 lanes over 1, 2, 8 and 64 shards where they divide,
   on six kinds of tagged batches; K12 (deal) against its twin on the
   same batches and on three deals where no lane moves, the kept scratch
   filled with a pattern and checked untouched past the dealt rows
   (``compare_deal_kernel``), K1 and K4 with the shard count, run_fused_mesh (4 rounds x 256 steps, every
   seed in shard 0, under sync debug mode "error", one K1 launch and one
   steal launch a round) on becstress (stats on) and BECToken, and one
   sharded_round with the deal (one K1 launch, one counting steal
   launch, one K12 call that is one kernel launch as mesh.cu counts
   them, no K9), each against the twin's run; the
   skew demos (MULTICHIP_r06's 64 lanes with 16 spinning on shards 0-1:
   one steal of 12 lanes, occupancy [2]*8, 4096 steps; and 512 lanes
   with 128 spinning: 96 lanes, [16]*8), held against the twin too;
   BECToken (3 tx, 120 s) through SymExecWrapper over the mesh
   (MYTHRIL_TPU_MESH=on; the strategy warms itself inside the run, as
   in the e2e phases): [101@28, 101@104], fused mesh rounds, no
   degraded round, one steal launch a round; then the steal kernel's
   times in each use on the 96-lane steal state and on a gated no-steal
   state (through its entry point, and the launch alone), its registers
   and the ptxas lines of mesh.cu; K12's time on the 128-lane steal
   state (its launch alone, behind a spinning kernel, through rebalance
   and within sharded_round, line ``timing_deal``), and the mesh
   super-round beside run_fused on the same seed;
13. the multi-tenant service (``run_service``), in this process after
   every other phase's analyses, at DEFAULT_BATCH_CFG's width with the
   engagement gate open: an AnalysisService (3 workers, a 1.0 s gather
   window) over a fleet DurableResultCache, behind a fleet Gateway over
   one LocalWorker, takes killable (tx 1, 180 s), originauth (tx 1,
   180 s) and becstress (tx 2, 60 s) at once; each must end done with its
   own issue set (106 and not 115, 115 and not 106, [101@8]), two or more
   jobs must share a device round, no round may degrade or retry, and K1,
   K4, K6 and K7 must launch in the phase; in the service's own output of
   the first shared round's dispatch (every round of it) and in a replay
   of its input through run_fused and the twin as one round of 64 steps
   (bit for bit), every alive lane must carry the job of the state it
   descends from; a resubmission of killable must come from the durable
   store in under 1% of its cold wall. It prints the phase's wall,
   rounds, shared rounds, jobs resident in one round and launches, and
   the card's name and power limit.

The last three lines are the kernels JSON (K1-K12), the card's name and
power limit, and {"ok": true, "device": {...}}. Any mismatch or
exception exits non-zero without that last line. Imports nothing of JAX.
"""

import functools
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory rate

STRESS_SRC = """
    PUSH1 0x00
    CALLDATALOAD            ; [amount]
    PUSH1 0x20
    CALLDATALOAD            ; [amount, cnt]
    DUP2
    DUP2
    MUL                     ; [amount, cnt, total]   (overflow site)
    CALLER
    PUSH1 0x00
    MSTORE                  ; mem[0..32] = caller
    PUSH1 0x20
    PUSH1 0x00
    SHA3                    ; [amount, cnt, total, slot]
    SLOAD                   ; [amount, cnt, total, bal]
    LT                      ; [amount, cnt, bal < total]
    PUSH2 :revert
    JUMPI                   ; insufficient balance -> revert
loop:
    JUMPDEST
    DUP1
    ISZERO
    PUSH2 :done
    JUMPI                   ; cnt == 0 -> done
    PUSH1 0x20
    PUSH1 0x00
    SHA3                    ; [amount, cnt, slot]
    DUP2
    SWAP1                   ; [amount, cnt, cnt, slot]
    SSTORE                  ; storage[slot] = cnt
    PUSH1 0x01
    SWAP1
    SUB                     ; [amount, cnt-1]
    PUSH2 :loop
    JUMP
done:
    JUMPDEST
    STOP
revert:
    JUMPDEST
    PUSH1 0x00
    PUSH1 0x00
    REVERT
"""

# fork on x, then on ISZERO(x): one child is must-UNSAT and spins until
# the in-loop screen's R3 rule kills it
INLOOP_DEMO_SRC = """
    PUSH1 0x00
    CALLDATALOAD            ; [x]
    PUSH2 :a
    JUMPI                   ; fork 1: taken asserts x != 0
    STOP
a:
    JUMPDEST
    PUSH1 0x00
    CALLDATALOAD
    ISZERO
    PUSH2 :spin
    JUMPI                   ; fork 2: taken asserts ISZERO(x) != 0
    STOP
spin:
    JUMPDEST
    PUSH2 :spin
    JUMP                    ; the must-UNSAT child never halts on its own
"""

# the backend's always-host opcodes (STOP, RETURN, REVERT, SUICIDE,
# ASSERT_FAIL): lanes freeze-trap there for the host
ALWAYS_HOST = (0x00, 0xF3, 0xFD, 0xFF, 0xFE)


def emit(obj):
    if "phase" in obj:  # seconds since the script started, to see where its time limit goes
        obj = {**obj, "t_s": round(time.time() - T0, 1)}
    print(json.dumps(obj), flush=True)


class HandoffProbe:
    """Where an analysis handed its frontier to the batch backend: at the
    first call of ``backend.exec_batch`` (the engagement gate,
    ``device_engage_after_s`` after the strategy was made, opened), the
    states the host had explored and the seconds since ``start``. The
    frontier at that point decides what the device explores: on BECToken
    a handoff before the host has run batchTransfer's loop gives that
    loop to the device, where 101@104 is not found (ROADMAP section C)."""

    def __init__(self):
        from mythril_tpu_torch.laser.cuda import backend

        self.backend, self.orig, self.t0, self.at = backend, backend.exec_batch, None, None

    def start(self):
        self.t0, self.at = time.time(), None
        self.backend.exec_batch = self.exec_batch

    def stop(self):
        self.backend.exec_batch = self.orig

    def exec_batch(self, laser, *args, **kwargs):
        if self.at is None:
            self.at = {"states": laser.total_states, "s": round(time.time() - self.t0, 3)}
        return self.orig(laser, *args, **kwargs)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mythril_tpu_torch.laser.cuda import _build, batch

    smi = smi_line()
    # ---- 1. build -------------------------------------------------------
    t0 = time.time()
    secs = _build.build_all()
    build_s = time.time() - t0
    regs = {}
    for name in _build.SOURCES:
        log = os.path.join(_build.BUILD_DIR, f"{name}.log")
        if os.path.exists(log):
            regs[name] = [ln.strip() for ln in open(log) if "registers" in ln or "spill" in ln][:12]
    emit({"phase": "build", "seconds": round(build_s, 3), "per_source": secs, "ptxas": regs, "gpu": smi})
    dev = torch.device("cuda")
    entries, fused_twins = run(dev, batch.DEFAULT_BATCH_CFG, smi)
    entries += run_host_half(dev, batch.DEFAULT_BATCH_CFG, smi)
    stats_entries, stats_k1_err = run_stats_and_sync(dev, batch.DEFAULT_BATCH_CFG, smi, fused_twins)
    entries += stats_entries
    mesh_entries, seg_err, (e2e_mesh_counts, one_card) = run_mesh(dev, batch.DEFAULT_BATCH_CFG, smi)
    cards_entries, cards_err = run_mesh_cards(dev, batch.DEFAULT_BATCH_CFG, smi, e2e_mesh_counts, one_card)
    seg_err["K1"] = max(seg_err["K1"], stats_k1_err, cards_err["K1"])
    seg_err["K4"] = max(seg_err["K4"], cards_err["K4"])
    for e in entries:  # K1 and K4 also ran with a shard count and over cards, K1 with stats
        kid = e["name"].split()[0]
        if kid in seg_err:
            e["max_abs_err"] = max(e["max_abs_err"], seg_err[kid])
    entries += mesh_entries + cards_entries
    # after every other analysis of this process, as a long-lived server
    # takes job after job
    run_service(dev, batch.DEFAULT_BATCH_CFG, smi)
    check_late_handoff()
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def run(dev, cfg, smi, k1_steps=64, rounds=16, steps_per_round=256):
    """Phases 2-4 on ``dev`` at ``cfg`` (the card at DEFAULT_BATCH_CFG;
    a CPU rehearsal at a small config runs the same flow on the twins).
    Returns the kernels line's entries, and for becstress and BECToken
    the main path's inputs and the twin's super-round on them, run with
    stats (the histogram leaves the planes as they are), which phase 9
    holds its stats super-rounds against: (code bank, batch, rounds,
    steps a round, twin's output) by contract."""
    import numpy as np
    import torch

    from mythril_tpu_torch.disassembler.asm import assemble
    from mythril_tpu_torch.laser.cuda import _build, batch, convert, engine, inloop_solve, keccak, kernels, megakernel
    from mythril_tpu_torch.support.keccak import keccak256

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def planes_equal(a, b):
        """(equal, max |a-b|) over every plane of two batches."""
        worst = 0
        for x, y in zip(a, b):
            if not torch.equal(x, y):
                worst = max(worst, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
                if worst == 0:
                    worst = 1
        return worst == 0, worst

    def first_diff(a, b):
        for name, x, y in zip(batch.StateBatch._fields, a, b):
            if not torch.equal(x, y):
                idx = (x != y).nonzero()[0].tolist()
                return f"{name}{idx}: kernel={x[tuple(idx)].item()} twin={y[tuple(idx)].item()}"
        return None

    max_err = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    def k1_launch(cb, st, n_steps, n_shards):
        """One K1 launch of n_steps on a copy of st (the twin's steps in
        the rehearsal); not counted."""
        if not on_card:
            return engine.step_n(cb, None, st, n_steps, device=dev, n_shards=n_shards)
        s = batch.StateBatch(*(x.clone() for x in st))
        kernels.launch_step_run(kernels.StepArgs(cb, s, n_shards), n_steps)
        return s

    # ---- 2. kernels against twins ---------------------------------------
    rng = np.random.default_rng(20261017)
    lens = [0, 1, 31, 32, 135, 136, 137, 271, 272, 273, 543, 544]
    data = torch.as_tensor(rng.integers(0, 256, (len(lens), 544), dtype=np.uint8), device=dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    k_out = keccak.keccak256_batch(data, ln, device=dev)
    t_out = keccak.keccak256_plain(data, ln)
    host = [keccak256(bytes(data[i, :n].cpu().numpy())) for i, n in enumerate(lens)]
    ok_host = all(bytes(k_out[i].cpu().numpy()) == host[i] for i in range(len(lens)))
    empty = torch.zeros((cfg.lanes, 544), dtype=torch.uint8, device=dev)
    e_len = torch.zeros(cfg.lanes, dtype=torch.int32, device=dev)
    ke = keccak.keccak256_batch(empty, e_len, device=dev)
    te = keccak.keccak256_plain(empty, e_len)
    ok_k2 = torch.equal(k_out, t_out) and torch.equal(ke, te) and ok_host
    ok_k2 = ok_k2 and bytes(ke[0].cpu().numpy()) == keccak256(b"")
    max_err["K2"] = max(int((k_out.int() - t_out.int()).abs().max()), int((ke.int() - te.int()).abs().max()))
    emit({"phase": "compare", "kernel": "K2", "lengths": lens, "empty_rows": cfg.lanes, "ok": ok_k2})
    if not ok_k2:
        raise AssertionError("K2 keccak differs from its twin or from the host keccak")

    sym = dict(symbolic_calldata=True, symbolic_storage=True, symbolic_caller=True, symbolic_callvalue=True)

    def seeds(n_sym, n_conc):
        specs = [dict(sym) for _ in range(n_sym)]
        for i in range(n_conc):
            cd = int(rng.integers(1, 2**31)).to_bytes(32, "big") + int(rng.integers(0, 6)).to_bytes(32, "big")
            specs.append(dict(calldata=cd + bytes(rng.integers(0, 256, 64, dtype=np.uint8)), caller=0x1000 + i))
        return specs

    contracts = {
        "becstress": assemble(STRESS_SRC),
        "bectoken": assemble(open(os.path.join(HERE, "bench_contracts", "bectoken.asm")).read()),
        "inloop_demo": assemble(INLOOP_DEMO_SRC),
    }

    def bank_for(code):
        return batch.make_code_bank(
            [code], cfg.code_len, host_ops=ALWAYS_HOST, freeze_errors=True,
            record_storage_events=True, prune_revert=True, device=dev,
        )

    k1_state = None
    for name in ("becstress", "bectoken"):
        cb = bank_for(contracts[name])
        n_cmp = min(32, cfg.lanes // 8)
        st_in = st_k = batch.build_batch(cfg, seeds(n_cmp, n_cmp), device=dev)
        st_t = st_k
        for i in range(k1_steps):
            st_k = engine.step(cb, None, st_k, device=dev)
            st_t = engine.step_plain(cb, st_t)
            same, err = planes_equal(st_k, st_t)
            max_err["K1"] = max(max_err["K1"], err)
            if not same:
                raise AssertionError(f"K1 differs from the twin on {name} at step {i}: {first_diff(st_k, st_t)}")
        sync()
        emit({"phase": "compare", "kernel": "K1", "contract": name, "steps": k1_steps, "lanes": cfg.lanes,
              "alive": int(st_k.alive.sum()), "running": int((st_k.alive & (st_k.status == 0)).sum()), "ok": True})
        if name == "bectoken":
            k1_state = (cb, st_k)
        # one launch of k1_steps steps against as many twin steps, with 1
        # and 8 lane blocks
        for n in (1, 8):
            want = st_t
            if n != 1:
                want = st_in
                for _ in range(k1_steps):
                    want = engine.step_plain(cb, want, n)
            got = k1_launch(cb, st_in, k1_steps, n)
            same, err = planes_equal(got, want)
            max_err["K1"] = max(max_err["K1"], err)
            if not same:
                raise AssertionError(f"K1 run ({k1_steps} steps, n_shards={n}) differs from the twin on {name}: "
                                     f"{first_diff(got, want)}")
            sync()
            emit({"phase": "compare", "kernel": "K1 run", "contract": name, "steps": k1_steps, "launches": 1,
                  "shards": n, "lanes": cfg.lanes, "alive": int(want.alive.sum()), "max_abs_err": err, "ok": True})

    def random_pool_case(seed, V=inloop_solve.POOL_VARS):
        r = np.random.default_rng(seed)
        L, P, T = cfg.lanes, cfg.path_slots, cfg.tape_slots
        st = batch.empty_batch(cfg, device=dev)
        hs = r.integers(0, 2**32, (48, 2), dtype=np.uint64).astype(np.uint32)
        pick = r.integers(0, 48, (L, T))
        st = st._replace(
            alive=torch.as_tensor(r.random(L) < 0.9, device=dev),
            status=torch.as_tensor(r.choice([0, 0, 0, 5], L).astype(np.int32), device=dev),
            path_len=torch.as_tensor(r.integers(0, 12, L).astype(np.int32), device=dev),
            path_id=torch.as_tensor(r.integers(0, 200, (L, P)).astype(np.int32), device=dev),
            path_sign=torch.as_tensor(r.random((L, P)) < 0.5, device=dev),
            tape_op=torch.as_tensor(r.choice([32, 10, 5, 3, 27], (L, T)).astype(np.int32), device=dev),
            tape_a=torch.as_tensor(r.integers(-1, 200, (L, T)).astype(np.int32), device=dev),
            tape_h1=torch.as_tensor(hs[pick, 0].view(np.int32), device=dev),
            tape_h2=torch.as_tensor(hs[pick, 1].view(np.int32), device=dev),
        )
        C, W = inloop_solve.POOL_CLAUSES, inloop_solve.POOL_WIDTH
        vsel = r.integers(0, 48, V)
        pool = convert.pool_to_torch(dict(
            var_h1=hs[vsel, 0], var_h2=hs[vsel, 1],
            lit_var=r.integers(0, V, (C, W)).astype(np.int32),
            lit_neg=r.random((C, W)) < 0.5, lit_used=r.random((C, W)) < 0.3,
        ), dev)
        return st, pool

    k3_case = random_pool_case(7)
    k3_cases = {"seed 7": k3_case, "seed 8": random_pool_case(8), "seed 9": random_pool_case(9),
                "V 256": random_pool_case(10, V=256),
                "empty pool": (random_pool_case(11)[0], inloop_solve.empty_pool(dev))}
    flagged = {}
    for label, (st, pool) in k3_cases.items():
        km = inloop_solve.unsat_mask(pool, st, device=dev)
        tm = inloop_solve.unsat_mask_plain(pool, st)
        if not torch.equal(km, tm):
            raise AssertionError(f"K3 differs from the twin on pool case {label}")
        flagged[label] = int(km.sum())
    emit({"phase": "compare", "kernel": "K3", "cases": list(k3_cases), "lanes": cfg.lanes, "flagged": flagged,
          "ok": True})

    def mixed_epilogue_case(seed):
        r = np.random.default_rng(seed)
        cb, st = k1_state
        L = cfg.lanes
        status = st.status.clone()
        trap_op = st.trap_op.clone()
        pick = torch.as_tensor(r.random(L), device=dev)
        status[pick < 0.15] = batch.REVERTED
        status[(pick >= 0.15) & (pick < 0.3)] = batch.TRAP
        trap_op[(pick >= 0.15) & (pick < 0.25)] = 0xFD
        st = st._replace(
            status=status, trap_op=trap_op,
            alive=st.alive | torch.as_tensor(r.random(L) < 0.3, device=dev),
            outermost=torch.as_tensor(r.random(L) < 0.8, device=dev),
            steps=torch.as_tensor(r.integers(0, 1000, L).astype(np.int32), device=dev),
            static_pruned=torch.as_tensor(r.integers(0, 5, L).astype(np.int32), device=dev),
        )
        unsat = torch.as_tensor(r.random(L) < 0.1, device=dev) & st.alive & (st.status == 0)
        return cb, st, unsat

    def k4_compare(label, cb, st, unsat, n=1, flags=kernels.EPI_COMMIT, gate=None):
        """One K4 launch against the twin: every plane, acc, pv, the
        control word, the order and the dying mask. A bare compaction
        (EPI_COMPACT_ONLY) is compact_plain with the gate open and the
        identity with it shut."""
        L = cfg.lanes
        acc0 = torch.tensor([3, (1 << 31) - 2, -5, 7], dtype=torch.int32, device=dev)
        acc_t, pv_t = acc0.clone(), torch.zeros(cb.code.shape, dtype=torch.bool, device=dev)
        compact_only = flags & kernels.EPI_COMPACT_ONLY
        if not compact_only:
            out_t = megakernel.round_epilogue_plain(cb, st, unsat, acc_t, pv_t, n)
            dying_t = megakernel.prune_mask(cb, st) | unsat
        else:
            open_ = gate is None or bool(gate[0])
            out_t = megakernel.compact_plain(st, n) if open_ else st
            dying_t = torch.zeros(L, dtype=torch.bool, device=dev)
        alive_after = (st.alive & ~dying_t).to(torch.int32).view(n, -1)
        order_t = (torch.argsort(alive_after, dim=1, descending=True, stable=True)
                   + torch.arange(0, L, L // n, device=dev)[:, None]).reshape(L).to(torch.int32)
        ctl_t = [2, 1, 9, 0] if compact_only else [2, 1, 3, int((out_t.alive & (out_t.status == 0)).any())]
        if flags & kernels.EPI_COMMIT:
            ctl_t[:2] = ctl_t[2:]
        st_k = batch.StateBatch(*(x.clone() for x in st))
        acc_k, pv_k = acc0.clone(), torch.zeros_like(pv_t)
        ctl = torch.tensor([2, 1, 9, 0] if compact_only else [2, 1, 0, 0], dtype=torch.int32, device=dev)
        scratch_k = batch.StateBatch(*(torch.empty_like(x) for x in st))
        if on_card:
            megakernel.round_epilogue(cb, st_k, unsat, acc_k, pv_k, ctl, 16, scratch_k, n, flags, gate)
            sc = kernels.Scratch.get(st_k.pc.device, L)
            ran = gate is None or bool(gate[0])
            order_ok = not ran or (torch.equal(sc.order, order_t) and torch.equal(sc.dying.bool(), dying_t))
        else:  # the rehearsal has no kernel: apply the twin and its control word
            st_k, acc_k, pv_k, order_ok = out_t, acc_t, pv_t, True
            ctl = torch.tensor(ctl_t, dtype=torch.int32)
        same, err = planes_equal(st_k, out_t)
        ok = same and order_ok and torch.equal(acc_k, acc_t) and torch.equal(pv_k, pv_t) and ctl.tolist() == ctl_t
        max_err["K4"] = max(max_err["K4"], err, 0 if ok else 1)
        moved = int((order_t != torch.arange(L, device=dev)).sum())
        emit({"phase": "compare", "kernel": "K4", "case": label, "lanes": L, "shards": n, "flags": flags,
              "gate": None if gate is None else int(gate[0]), "moved": moved, "dying": int(dying_t.sum()),
              "acc": acc_k.tolist(), "ctl": ctl.tolist(), "ok": bool(ok)})
        if not ok:
            raise AssertionError(f"K4 differs from the twin on {label}: {first_diff(st_k, out_t)} "
                                 f"acc {acc_k.tolist()} vs {acc_t.tolist()} ctl {ctl.tolist()} vs {ctl_t}")

    cb4, st4, unsat4 = mixed_epilogue_case(11)
    k4_compare("mixed", cb4, st4, unsat4)
    pv_t = torch.zeros(cb4.code.shape, dtype=torch.bool, device=dev)
    scratch = batch.StateBatch(*(torch.empty_like(x) for x in st4))
    # an order where nothing moves, one where every lane moves, and dying
    # lanes that keep their place (62 reverts, 63 is killed: both must be
    # zeroed where they are)
    L = cfg.lanes
    lane_ix = torch.arange(L, device=dev)
    zeros_L = torch.zeros(L, dtype=torch.bool, device=dev)
    st_run = st4._replace(status=torch.zeros_like(st4.status), outermost=torch.ones_like(st4.outermost))
    st_identity = st_run._replace(alive=lane_ix < L // 2)
    k4_compare("identity", cb4, st_identity, zeros_L)
    k4_compare("all move", cb4, st_run._replace(alive=lane_ix > 0), zeros_L)
    in_place = st_run._replace(alive=lane_ix < 64, status=torch.where(lane_ix == 62, batch.REVERTED, 0).to(torch.int32))
    k4_compare("dying in place", cb4, in_place, lane_ix == 63)
    # eight lane blocks (the fused mesh tier), with each flag and gate
    gate0, gate1 = (torch.tensor([g], dtype=torch.int32, device=dev) for g in (0, 1))
    for flags, gate in ((0, None), (kernels.EPI_COMMIT, None),
                        (kernels.EPI_COMMIT | kernels.EPI_COMPACT_ONLY, gate0),
                        (kernels.EPI_COMMIT | kernels.EPI_COMPACT_ONLY, gate1), (kernels.EPI_COMPACT_ONLY, gate1)):
        k4_compare("sharded", cb4, st4, unsat4, 8, flags, gate)

    # ---- 3. the main path ----------------------------------------------
    n_seeds = min(16, cfg.lanes // 4)
    inputs = {}
    for name, code in contracts.items():
        specs = [dict(sym) for _ in range(n_seeds // 2)] + seeds(0, n_seeds // 2)
        inputs[name] = (bank_for(code), batch.build_batch(cfg, specs, device=dev))
    pool0 = inloop_solve.empty_pool(dev)
    sync()
    engine.launches = engine.steps_run = keccak.launches = inloop_solve.launches = megakernel.launches = 0
    results = {}
    for name, (cb, st) in inputs.items():
        t0 = time.perf_counter()
        if on_card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = megakernel.run_fused(cb, None, st, max_rounds=rounds, steps_per_round=steps_per_round,
                                       with_solve=True, pool=pool0, device=dev)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        t_enq = time.perf_counter()
        stats = megakernel.decode_info(out.info)  # the one blocking fetch
        t1 = time.perf_counter()
        results[name] = (out, stats, (t1 - t0) * 1e3, (t_enq - t0) * 1e3)
    counts = {"K1": engine.launches, "K1_steps": engine.steps_run, "K2": keccak.launches,
              "K3": inloop_solve.launches, "K4": megakernel.launches}
    for name, (out, stats, wall, enq) in results.items():
        retired = int(out.st.steps.sum()) + stats.pruned_steps
        forked = stats.n_alive + stats.pruned_lanes + stats.inloop_kills - n_seeds
        emit({"phase": "main_path", "contract": name, "info": stats._asdict(), "steps_retired": retired,
              "lanes_alive": stats.n_alive, "lanes_forked": forked, "wall_ms": round(wall, 3),
              "enqueue_ms": round(enq, 3), "launches": counts})
        if forked <= 0:
            raise AssertionError(f"{name}: no fork filled a lane beyond the {n_seeds} seeds")
    if results["inloop_demo"][1].inloop_kills < 1:
        raise AssertionError("the in-loop demo reported no in-loop kill")
    if on_card and min(counts[k] for k in ("K1", "K3", "K4")) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {counts}")
    # one K1 launch per round runs the round's steps; SHA3 is hashed inside K1
    n_runs = len(inputs)
    if on_card and (counts["K1"] != n_runs * rounds or counts["K1_steps"] != n_runs * rounds * steps_per_round
                    or counts["K2"] != 0):
        raise AssertionError(f"the main path did not run one K1 launch per round and no K2: {counts}")
    fused_twins = {}
    for name, (cb, st) in inputs.items():
        out_k = results[name][0]
        out_t = megakernel.run_fused_plain(cb, st, rounds, steps_per_round, True, pool0, with_stats=True)
        if name != "inloop_demo":
            fused_twins[name] = (cb, st, rounds, steps_per_round, out_t)
        same, err = planes_equal(out_k.st, out_t.st)
        ok = same and torch.equal(out_k.info, out_t.info) and torch.equal(out_k.pruned_visited, out_t.pruned_visited)
        max_err["K1"] = max(max_err["K1"], err)
        emit({"phase": "main_path_vs_twin", "contract": name, "info": out_t.info.tolist(), "ok": bool(ok)})
        if not ok:
            raise AssertionError(f"{name}: fused kernels differ from the twin: {first_diff(out_k.st, out_t.st)}")
        # K3 at the main path's own state
        km = inloop_solve.unsat_mask(pool0, out_k.st, device=dev)
        if not torch.equal(km, inloop_solve.unsat_mask_plain(pool0, out_k.st)):
            raise AssertionError(f"{name}: K3 differs from the twin on the main path's state")

    # ---- 4. times on the card --------------------------------------------
    def time_ms(fn, prep=None, reps=20, spin=False):
        """Mean device time of fn over reps (CUDA events); the rehearsal
        reports host time, which is no device figure and is not kept.
        With ``spin`` each rep is queued behind a spinning kernel, so the
        events time the device's work alone and not the host's launch."""
        for _ in range(3 if on_card else 1):
            a = prep() if prep else None
            fn(a)
        sync()
        total = 0.0
        reps = reps if on_card else 1
        for _ in range(reps):
            a = prep() if prep else None
            if on_card:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                if spin:
                    sync()
                    torch.cuda._sleep(2_000_000)
                e0.record()
                fn(a)
                e1.record()
                torch.cuda.synchronize()
                total += e0.elapsed_time(e1)
            else:
                t = time.perf_counter()
                fn(a)
                total += (time.perf_counter() - t) * 1e3
        return total / reps

    def row_bytes(st):
        return sum(x[0].numel() * x.element_size() for x in st)

    cb1, st1 = k1_state

    def clone1():
        s = batch.StateBatch(*(x.clone() for x in st1))
        return s, (kernels.StepArgs(cb1, s) if on_card else None)

    def k1_bytes(before, after):
        # per running lane: fetch byte, 7 scalar planes read, top-3 words and
        # tags read, 6 scalars + one word and tag written, the visited byte;
        # each child needs its whole row written
        running = int((before.alive & (before.status == 0)).sum())
        children = int(after.alive.sum() - before.alive.sum())
        return running * (1 + 7 * 4 + 3 * 68 + 6 * 4 + 68 + 1) + children * row_bytes(before), running, children

    ms_k1 = time_ms(lambda a: engine.step(cb1, None, a[0], device=dev, inplace=True, args=a[1]), clone1)
    plain_k1 = time_ms(lambda a: engine.step_plain(cb1, a[0]), clone1, reps=5)
    after = engine.step(cb1, None, st1, device=dev)
    bytes_k1, running, children = k1_bytes(st1, after)
    # one launch of a round's steps on the same state; its bound sums the
    # bytes of each of its steps, taken one step at a time
    run_steps = steps_per_round
    ms_k1_run = time_ms(lambda a: engine.step_n(cb1, None, a[0], run_steps, device=dev, inplace=True, args=a[1]),
                        clone1, reps=10)
    bytes_run, s_run, live_steps = 0, st1, 0
    for _ in range(run_steps):
        nxt = engine.step(cb1, None, s_run, device=dev)
        b, r, _c = k1_bytes(s_run, nxt)
        if not r:
            break
        bytes_run, s_run, live_steps = bytes_run + b, nxt, live_steps + 1
    # the twin over the same steps, once (it is warm from the compares)
    sync()
    t0 = time.perf_counter()
    s_plain = st1
    for _ in range(run_steps):
        s_plain = engine.step_plain(cb1, s_plain)
    sync()
    plain_k1_run = (time.perf_counter() - t0) * 1e3
    emit({"phase": "timing", "what": "K1 one step and one launch of a round", "state": "bectoken after "
          f"{k1_steps} steps", "running": running, "children": children, "ms_one_step": round(ms_k1, 6),
          "plain_ms_one_step": round(plain_k1, 6), "bound_ms_one_step": round(bytes_k1 / HBM_BYTES_PER_S * 1e3, 9),
          "steps_per_launch": run_steps, "steps_with_a_running_lane": live_steps, "ms_launch": round(ms_k1_run, 6),
          "plain_ms_launch": round(plain_k1_run, 3), "bound_ms_launch": round(bytes_run / HBM_BYTES_PER_S * 1e3, 9),
          "gpu": smi})
    # the floor of a step: every lane spinning on JUMPDEST, PUSH1, JUMP
    # (no fork, no memory), so a step is little more than the rank and
    # the two grid barriers
    cb_spin = bank_for(assemble(LOOP_SRC))
    st_spin = batch.build_batch(cfg, [dict(calldata=b"", gas=10_000_000)] * cfg.lanes, device=dev)

    def spin_prep():
        s = batch.StateBatch(*(x.clone() for x in st_spin))
        return s, (kernels.StepArgs(cb_spin, s) if on_card else None)

    spin = time_ms(lambda a: engine.step_n(cb_spin, None, a[0], run_steps, device=dev, inplace=True, args=a[1]),
                   spin_prep, reps=10)
    emit({"phase": "timing", "what": "K1 floor", "lanes_running": cfg.lanes, "steps": run_steps,
          "ms_launch": round(spin, 6), "us_per_step": round(spin * 1e3 / run_steps, 3), "gpu": smi})
    if on_card:
        log = os.path.join(_build.BUILD_DIR, "step.log")
        ptxas = [ln.strip() for ln in open(log) if "registers" in ln or "spill" in ln] if os.path.exists(log) else []
        info = kernels.step_run_info(dev)
        # a cooperative launch of one block more than the card holds at
        # once is refused by the runtime; the wrapper must raise, and the
        # next launch must run as before
        s_ref, a_ref = clone1()
        refused = None
        try:
            kernels.launch_step_run(a_ref, 1, None, blocks=info["blocks_per_sm"] * info["sms"] + 1)
        except _build.KernelError as e:
            refused = str(e)
        kernels.launch_step_run(a_ref, 1)
        sync()
        same, _err = planes_equal(s_ref, after)
        emit({"phase": "timing", "what": "K1 registers and spills", **info,
              "stats_instance": kernels.step_run_info(dev, stats=True), "ptxas": ptxas,
              "refused_cooperative_launch": refused, "next_launch_exact": same})
        if refused is None or "cooperative" not in refused.lower():
            raise AssertionError(f"an oversized cooperative K1 launch did not raise its refusal: {refused}")
        if not same:
            raise AssertionError("K1 after a refused launch differs from the step before it")
        regs = {}
        for kid, src, info in (("K3", "inloop", kernels.unsat_info(dev)), ("K4", "megakernel", kernels.epilogue_info(dev))):
            log = os.path.join(_build.BUILD_DIR, f"{src}.log")
            lines = [ln.strip() for ln in open(log) if "registers" in ln or "spill" in ln] if os.path.exists(log) else []
            regs[kid] = {**info, "ptxas": lines}
        emit({"phase": "timing", "what": "K3/K4 registers and spills", **regs})

    L = cfg.lanes
    off = torch.zeros(L, dtype=torch.int32, device=dev)
    avail = torch.full((L,), cfg.memory_bytes, dtype=torch.int32, device=dev)
    wlen = torch.full((L,), 64, dtype=torch.int32, device=dev)
    act = torch.ones(L, dtype=torch.uint8, device=dev)
    dig = torch.zeros((L, 32), dtype=torch.uint8, device=dev)
    wk = keccak.keccak256_window(st1.memory, off, avail, wlen, act, dig)
    wt = keccak.keccak256_window_plain(st1.memory, off, avail, wlen)
    if not torch.equal(wk, wt):
        raise AssertionError("K2 window form differs from its twin at the main path's shapes")
    ms_k2 = time_ms(lambda _: keccak.keccak256_window(st1.memory, off, avail, wlen, act, dig))
    plain_k2 = time_ms(lambda _: keccak.keccak256_window_plain(st1.memory, off, avail, wlen), reps=5)
    bytes_k2 = L * (64 + 4 * 4 + 1 + 32)

    st3, pool3 = k3_case
    if on_card:  # as the loops launch it: its arguments built once
        k3_args = kernels.UnsatArgs(pool3, st3)
        ms_k3 = time_ms(lambda _: kernels.launch_unsat(pool3, st3, args=k3_args))
        ms_k3_device = time_ms(lambda _: kernels.launch_unsat(pool3, st3, args=k3_args), spin=True)
        # the same lanes with the empty pool: what the pool's sweeps cost
        pool_empty = inloop_solve.empty_pool(dev)
        k3_empty = kernels.UnsatArgs(pool_empty, st3)
        ms_k3_empty = time_ms(lambda _: kernels.launch_unsat(pool_empty, st3, args=k3_empty), spin=True)
        # the arguments built in the call, as a caller with no loop does
        ms_k3_built = time_ms(lambda _: inloop_solve.unsat_mask(pool3, st3, device=dev))
    else:
        ms_k3 = ms_k3_device = ms_k3_empty = ms_k3_built = time_ms(
            lambda _: inloop_solve.unsat_mask(pool3, st3, device=dev))
    plain_k3 = time_ms(lambda _: inloop_solve.unsat_mask_plain(pool3, st3), reps=5)
    elig = st3.alive & (st3.status == 0)
    valid_entries = int(torch.minimum(st3.path_len, torch.tensor(cfg.path_slots, device=dev))[elig].sum())
    pool_bytes = sum(x.numel() * x.element_size() for x in pool3)
    bytes_k3 = int(elig.sum()) * (cfg.path_slots * 5 + 4) + valid_entries * 16 + pool_bytes + L * (1 + 4 + 1)

    def prep4(st_in=st4, unsat_in=unsat4):
        """A fresh batch and accumulators, and (on the card) the launch's
        arguments built for them, as the loops build them once."""
        a = (batch.StateBatch(*(x.clone() for x in st_in)), torch.zeros(4, dtype=torch.int32, device=dev),
             torch.zeros_like(pv_t), torch.tensor([0, 1, 0, 0], dtype=torch.int32, device=dev))
        k4_args = kernels.EpilogueArgs(cb4, a[0], unsat_in, a[1], a[2], a[3], 16, scratch) if on_card else None
        return a + (k4_args,)

    def k4_call(a, unsat_in=unsat4):
        if on_card:
            megakernel.round_epilogue(cb4, a[0], unsat_in, a[1], a[2], a[3], 16, scratch, args=a[4])
        else:
            megakernel.round_epilogue_plain(cb4, a[0], unsat_in, a[1], a[2])

    ms_k4 = time_ms(k4_call, prep4)
    ms_k4_device = time_ms(k4_call, prep4, spin=True)
    ms_k4_built = time_ms(lambda a: megakernel.round_epilogue(cb4, a[0], unsat4, a[1], a[2], a[3], 16, scratch),
                          prep4) if on_card else ms_k4
    # the same launch where no row moves (half the lanes alive, in place, none dying)
    ms_k4_identity = time_ms(lambda a: k4_call(a, zeros_L), lambda: prep4(st_identity, zeros_L), spin=True)
    plain_k4 = time_ms(lambda a: megakernel.round_epilogue_plain(cb4, a[0], unsat4, a[1], a[2]), prep4, reps=5)
    dying4 = megakernel.prune_mask(cb4, st4) | unsat4
    order = torch.argsort((st4.alive & ~dying4).to(torch.int32), descending=True, stable=True)
    moved = int((order != torch.arange(L, device=dev)).sum())
    dying_n = int(dying4.sum())
    bytes_k4 = L * (1 + 4 + 4 + 1 + 1 + 4 + 4) + moved * 2 * row_bytes(st4) + dying_n * 2 * cfg.code_len

    def entry(kid, name, source, replaces, ms, plain, nbytes):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[kid], "max_abs_err": max_err[kid], "ms": round(ms, 6),
                "plain_ms": round(plain, 6), "bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 9),
                "bound_by": "bytes", "library_ms": None}

    kernels_line = {"kernels": [
        # a main-path launch runs a round's steps: its time, bound and twin;
        # one step's beside them. "steps" sums the steps the launches asked
        # for: a launch ends early once no lane runs
        dict(entry("K1", "K1 step", "mythril_tpu_torch/csrc/step.cu", "mythril_tpu/laser/tpu/engine.py:118",
                   ms_k1_run, plain_k1_run, bytes_run), steps=counts["K1_steps"], steps_per_launch=run_steps,
             ms_one_step=round(ms_k1, 6), plain_ms_one_step=round(plain_k1, 6),
             bound_ms_one_step=round(bytes_k1 / HBM_BYTES_PER_S * 1e3, 9)),
        entry("K2", "K2 keccak256_batch", "mythril_tpu_torch/csrc/keccak.cu",
              "mythril_tpu/laser/tpu/keccak_tpu.py:126", ms_k2, plain_k2, bytes_k2),
        # ms: CUDA events around the wrapper's call, as for every kernel
        # here; ms_device: the same call queued behind a spinning kernel,
        # so the host's launch time is not counted; ms_args_each_call: the
        # wrapper's call with its launch arguments built inside it
        dict(entry("K3", "K3 unsat_mask", "mythril_tpu_torch/csrc/inloop.cu",
                   "mythril_tpu/laser/tpu/inloop_solve.py:123", ms_k3, plain_k3, bytes_k3),
             ms_device=round(ms_k3_device, 6), ms_device_empty_pool=round(ms_k3_empty, 6),
             ms_args_each_call=round(ms_k3_built, 6)),
        dict(entry("K4", "K4 round_epilogue", "mythril_tpu_torch/csrc/megakernel.cu",
                   "mythril_tpu/laser/tpu/megakernel.py:204", ms_k4, plain_k4, bytes_k4),
             ms_device=round(ms_k4_device, 6), ms_device_no_row_moves=round(ms_k4_identity, 6),
             ms_args_each_call=round(ms_k4_built, 6)),
    ]}
    emit({"phase": "timing", "k1_state": {"running": running, "children": children},
          "k4_state": {"moved": moved, "dying": dying_n},
          "main_path_ms": {name: {"wall": round(r[2], 3), "enqueue": round(r[3], 3), "rounds": r[1].rounds}
                           for name, r in results.items()}, "gpu": smi})
    return kernels_line["kernels"], fused_twins



def compare_transfer(dev, cfg, max_err):
    """Phase 5: K6 unpack and K7 pack against their twins at ``cfg`` on
    full, tape-sliced, groups-absent, alive-prefix and bool-bytes batches
    (every bool plane holding bytes 0-255), each with the host -> card ->
    host round trip of every plane, and ``shard_lanes`` downloads of 8
    lane blocks (the bulky planes, and the small ones: 400 segments); a
    table of 16 blocks of the small planes must raise KernelError (past
    ``XFER_MAX_SEGS``). Raises on any difference; folds each compare's error into
    ``max_err`` and returns the cases by kind (numpy planes, upload parts,
    the card batch, t_used, l_used)."""
    import numpy as np
    import torch

    from mythril_tpu_torch.laser.cuda import _build, batch, convert, transfer
    from mythril_tpu_torch.laser.cuda.batch import StateBatch

    on_card = dev.type == "cuda"
    small = tuple(f for f in StateBatch._fields if f not in transfer._SKIP_DOWN and f not in transfer._BIG_DOWN)
    dtypes = {k: dt for k, (_s, dt) in batch.batch_shapes(cfg).items()}

    def diff(a, b):
        """max |a - b| over two tensors (0 when equal)."""
        if torch.equal(a, b):
            return 0
        return max(1, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))

    def random_planes(seed, kind):
        rng = np.random.default_rng(seed)
        nb = {}
        for name, (shape, dt) in batch.batch_shapes(cfg).items():
            if dt == np.bool_ and kind == "bool_bytes":  # bool planes holding bytes 0-255
                nb[name] = rng.integers(0, 256, shape, dtype=np.uint8).view(np.bool_)
            elif dt == np.bool_:
                nb[name] = rng.random(shape) < 0.5
            else:
                nb[name] = rng.integers(0, np.iinfo(dt).max, shape, dtype=dt)
        if kind in ("tape_sliced", "alive_prefix"):
            nb["tape_len"][:] = 5
            for f in transfer._TAPE_PLANES:
                nb[f][:, transfer._tape_cols(f, 5):] = 0
        if kind == "groups_absent":
            for g in ("memory", "storage"):
                for plane in transfer._UP_GROUPS[g]:
                    nb[plane][:] = 0
        if kind == "alive_prefix":
            nb["alive"][:] = False
            nb["alive"][: cfg.lanes // 5] = True
        return nb

    def raw(x):  # a plane's bytes (a bool plane's too, whatever they hold)
        return x.contiguous().view(torch.uint8)

    xfer_cases = {}
    for seed, kind in enumerate(("full", "tape_sliced", "groups_absent", "alive_prefix", "bool_bytes")):
        nb = random_planes(100 + seed, kind)
        parts = transfer.batch_parts(nb, cfg)
        planes_k = transfer.upload(parts, dev)
        buf, segs = convert.upload_to_torch(parts, dev)
        planes_t = transfer.unpack_plain(buf, segs)
        err6 = max(diff(raw(a), raw(b)) for a, b in zip(planes_k, planes_t))
        st = StateBatch(*planes_k)
        nb = {k: v.view(np.uint8) != 0 if v.dtype == np.bool_ else v for k, v in nb.items()}
        up_ok = all(np.array_equal(convert.to_numpy(getattr(st, k), dtypes[k]), nb[k]) for k in nb)
        t_used, l_used = transfer.down_plan(nb["tape_len"], nb["alive"], cfg.tape_slots)
        err7 = max(diff(transfer.pack(st, small), transfer.pack_plain(st, small)),
                   diff(transfer.pack(st, transfer._BIG_DOWN, t_used, l_used),
                        transfer.pack_plain(st, transfer._BIG_DOWN, t_used, l_used)))
        back = transfer.batch_to_host(st)
        rows = l_used or cfg.lanes
        down_ok = all(
            np.array_equal(getattr(back, k)[:rows] if k in transfer._BIG_DOWN else getattr(back, k),
                           nb[k][:rows] if k in transfer._BIG_DOWN else nb[k])
            for k in nb if k not in transfer._SKIP_DOWN
        )
        max_err["K6"] = max(max_err["K6"], err6)
        max_err["K7"] = max(max_err["K7"], err7)
        xfer_cases[kind] = (nb, parts, st, t_used, l_used)
        emit({"phase": "compare", "kernel": "K6/K7", "case": kind, "shipped_bytes": int(buf.numel()),
              "t_used": t_used, "l_used": l_used, "k6_err": err6, "k7_err": err7,
              "roundtrip_up": bool(up_ok), "roundtrip_down": bool(down_ok)})
        if err6 or err7 or not up_ok or not down_ok:
            raise AssertionError(f"K6/K7 differ from their twins or lose planes on the {kind} batch")
    # the mesh tiers' download: one lane bucket per shard block (the small
    # planes so give a table in the largest parameter class)
    st, t_used = xfer_cases["tape_sliced"][2], xfer_cases["tape_sliced"][3]
    shard_lanes = (8, max(1, cfg.lanes // 32))
    for label, fields in (("big planes", transfer._BIG_DOWN), ("small planes", small)):
        got = transfer.pack(st, fields, t_used, None, shard_lanes)
        err7 = diff(got, transfer.pack_plain(st, fields, t_used, None, shard_lanes))
        max_err["K7"] = max(max_err["K7"], err7)
        emit({"phase": "compare", "kernel": "K7", "case": f"shard_lanes, {label}", "shard_lanes": list(shard_lanes),
              "segments": len(fields) * shard_lanes[0], "t_used": t_used, "bytes": int(got.numel()), "k7_err": err7})
        if err7:
            raise AssertionError(f"K7 differs from its twin on a shard_lanes download of the {label}")
    if on_card:  # a table past what one launch takes is refused, not split
        refused = None
        try:
            transfer.pack(st, small, None, None, (16, 1))
        except _build.KernelError as e:
            refused = str(e)
        emit({"phase": "compare", "kernel": "K7", "case": "table past the launch's limit",
              "segments": len(small) * 16, "refused": refused})
        if refused is None:
            raise AssertionError("K7 took a table past XFER_MAX_SEGS instead of raising KernelError")
    if on_card:
        torch.cuda.synchronize()
    return xfer_cases



EXPECTED_ISSUES = {"becstress": [("101", 8)], "bectoken": [("101", 28), ("101", 104)]}
# BECToken's 101@104 lies on a path where receivers read from different
# calldata words alias one storage slot. The device's storage plane matches
# symbolic keys by term, as the reference's does, so only the host explores
# that path: an analysis finds 101@104 where the host has run tx 1's
# batchTransfer loop before the engagement gate (device_engage_after_s, the
# reference's 1.5 s of wall clock) hands the frontier to the device, and
# misses it where the gate opens earlier (ROADMAP.md section C). Replays
# with the gate opened at a state count (mythril_tpu_torch/ab_becstress.py
# --device cpu --engage-after-states N) find [101@28] alone for N <= 88 and
# both issues for N >= 89; on the card, handoffs at 64-82 states missed
# 101@104 and handoffs at 93-152 states found it.
LOOP_HANDOFF_STATES = 89
EARLY_HANDOFF_ISSUES = {"bectoken": [("101", 28)]}
E2E_RUNS = []  # (phase, contract, handoff, early) of every e2e analysis this run


def expected_issues(phase, name, handoff):
    """The issue set the reference's semantics give an analysis of ``name``
    whose engagement gate opened at ``handoff`` (``HandoffProbe.at``), and
    whether that handoff came before the host ran BECToken's loop. Records
    the analysis in ``E2E_RUNS``; ``check_late_handoff`` then demands that
    at least one BECToken analysis of the run was held to the full set."""
    early = name in EARLY_HANDOFF_ISSUES and handoff is not None and handoff["states"] < LOOP_HANDOFF_STATES
    E2E_RUNS.append((phase, name, handoff, early))
    return (EARLY_HANDOFF_ISSUES if early else EXPECTED_ISSUES)[name], early


def check_late_handoff():
    """Fails unless some BECToken analysis of this run handed off after the
    host ran the loop, so that 101@104 was demanded of the port on the card."""
    runs = [r for r in E2E_RUNS if r[1] in EARLY_HANDOFF_ISSUES]
    emit({"phase": "e2e_handoffs", "loop_handoff_states": LOOP_HANDOFF_STATES,
          "runs": [{"phase": p, "contract": c, "handoff": h, "before_loop": e} for p, c, h, e in runs]})
    if runs and all(e for *_, e in runs):
        raise AssertionError(f"every BECToken analysis handed off before {LOOP_HANDOFF_STATES} states, so none "
                             f"was held to {EXPECTED_ISSUES['bectoken']}: {runs}")


def compare_solve(dev, max_err, formula_widths=(8, 32, 96, 192), solve_flips=(0, 64, 4096)):
    """Phase 6: K5 against its twin on CNFs compiled from seeded formulas,
    on every (vars, clauses) bucket at 8 and 64 instances, at each of
    ``solve_flips``; every SAT row must satisfy its CNF and agree with the
    flips=0 phase. Adds K5's error into ``max_err``; returns the cases
    (bucket, operands, flips, seed, sweeps). Alone:

        python3 -c 'import chip_smoke, torch; chip_smoke.compare_solve(torch.device("cuda"), {"K5": 0})'
    """
    import random

    import numpy as np
    import torch

    from mythril_tpu_torch.laser.cuda import convert, solver

    def diff(a, b):
        """max |a - b| over two tensors (0 when equal)."""
        if torch.equal(a, b):
            return 0
        return max(1, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))

    from mythril_tpu_torch.smt import Not, Or, UGT, ULT, symbol_factory

    def formula_sets(width, n, seed):
        rng = random.Random(seed)
        a, b, c = (symbol_factory.BitVecSym(f"k5w{width}_{seed}_{x}", width) for x in "abc")

        def val(v):
            return symbol_factory.BitVecVal(v % (1 << width), width)

        out = []
        for k in range(n):
            base = [a + val(k) == b, ULT(a, val(rng.randrange(1 << width)))]
            extra = rng.sample([
                UGT(b, val(rng.randrange(1 << width))), b - a == c,
                Or(a == val(5), b == val(rng.randrange(1 << width))), Not(c == val(9)),
                a & val(0xFF) == val(rng.randrange(256)), c == val(rng.randrange(1 << width)),
            ], rng.randrange(1, 4))
            out.append([t.raw for t in base + extra])
        return out

    ladder = solver.shape_ladder()
    by_bucket = {step: [] for step in ladder}
    for width in formula_widths:
        for inst in solver.compile_cnf_batch(formula_sets(width, 12, width), solver.MAX_VARS, solver.MAX_CLAUSES):
            if inst is None or inst.trivial is not None:
                continue
            for step in ladder:
                if inst.nvars <= step[0] and inst.clause_arr.shape[0] <= step[1]:
                    by_bucket[step].append(inst)
                    break
    rng5 = np.random.default_rng(5)

    def satisfied(lits, assign):
        """bool[I]: every real clause has a true literal under assign."""
        var = (lits.abs() - 1).clamp(min=0).to(torch.int64)
        val = torch.gather(assign, 1, var.reshape(lits.shape[0], -1)).reshape(lits.shape)
        true = (lits != 0) & (val == (lits > 0))
        return (true.any(-1) | (lits == 0).all(-1)).all(-1)

    k5_cases = []
    for (V_b, C_b), insts in by_bucket.items():
        if not insts:
            raise AssertionError(f"no seeded formula compiled into the ({V_b}, {C_b}) bucket")
        for n_inst in (8, 40):
            chunk = [insts[i % len(insts)] for i in range(n_inst)]
            lits, nvars, is_input, V = solver._pack_batch(chunk, V_b, C_b)
            warm = np.where(rng5.random(is_input.shape) < 0.25, rng5.choice([-1, 1], is_input.shape), 0)
            warm = np.where(np.arange(V)[None, :] < nvars[:, None], warm, 0).astype(np.int8)
            ops = convert.solver_operands_to_torch((lits, nvars, is_input, warm), dev)
            p1 = None
            for flips in solve_flips:
                seed = 1000 + flips + n_inst
                k_out = solver.solve(*ops, flips, seed, device=dev)
                t_out = solver.solve_plain(*ops, flips, seed)
                err = max(diff(a, b) for a, b in zip(k_out, t_out))
                max_err["K5"] = max(max_err["K5"], err)
                status, assign, sweeps = k_out
                sat = status == solver.SAT
                sat_ok = bool(satisfied(ops[0], assign)[sat].all())
                if p1 is None:
                    p1 = status
                    p1_ok = True
                else:
                    decided = p1 != solver.UNKNOWN
                    p1_ok = bool((status[decided] == p1[decided]).all()) and bool(
                        (p1[status == solver.UNSAT] == solver.UNSAT).all())
                emit({"phase": "compare", "kernel": "K5", "bucket": [V_b, C_b], "I": int(lits.shape[0]),
                      "flips": flips, "status": {str(c): int((status == c).sum()) for c in
                                                 (solver.SAT, solver.UNSAT, solver.UNKNOWN)},
                      "sweeps_max": int(sweeps.max()), "sweeps_mean": round(float(sweeps.float().mean()), 3),
                      "err": err, "sat_rows_satisfy": sat_ok, "phase1_consistent": p1_ok})
                if err or not sat_ok or not p1_ok:
                    raise AssertionError(f"K5 differs from its twin or is unsound at bucket ({V_b}, {C_b}), "
                                         f"I={lits.shape[0]}, flips={flips}")
                k5_cases.append(((V_b, C_b), ops, flips, seed, sweeps))
    return k5_cases


def time_solve_per_sweep(dev, smi, cases, max_err, reps=20):
    """K5's time a sweep on each case (label: (operands, flips, seed)), at
    the bucket's own block size and at 256, 512 and 1024 threads, each
    launch's outputs first held against the twin's (its error added into
    ``max_err``): ``ms`` (CUDA events around the launch) and
    ``ms_device`` (queued behind a spinning kernel), each also divided by
    the case's largest sweep count; with the launch's resources and the
    ptxas lines of solve.cu (line ``timing_k5``). Returns the rows. The
    CPU rehearsal times the twin once (host time, not kept)."""
    import torch

    from mythril_tpu_torch.laser.cuda import _build, kernels, solver

    on_card = dev.type == "cuda"
    time_ms = functools.partial(events_ms, dev, reps=reps)
    rows = {}
    for label, (ops, flips, seed) in cases.items():
        I_, C_, _ = ops[0].shape
        V_ = ops[2].shape[1]
        want = solver.solve_plain(*ops, flips, seed)
        row = {"I": int(I_), "V": int(V_), "C": int(C_), "flips": flips, "sweeps_max": int(want[2].max()),
               "bytes": int(sum(t.numel() * t.element_size() for t in ops) + I_ * (4 + V_ + 4))}
        for threads in (0, 256, 512, 1024) if on_card else (0,):
            outs = [torch.empty_like(w) for w in want]

            def call(_, threads=threads, ops=ops, flips=flips, seed=seed, outs=outs):
                if on_card:
                    kernels.launch_solve(*ops, *outs, flips, seed, threads)
                else:
                    for o, w in zip(outs, solver.solve(*ops, flips, seed, device=dev)):
                        o.copy_(w)

            call(None)
            err = max(tensor_diff(a, b) for a, b in zip(outs, want))
            max_err["K5"] = max(max_err["K5"], err)
            if err:
                raise AssertionError(f"K5 at {threads or 'its own'} threads differs from the twin on {label}")
            ms_, dev_ms = time_ms(call), time_ms(call, spin=True)
            info = kernels.solve_info(dev, C_, V_, threads) if on_card else {}
            row[f"t{threads}" if threads else "own"] = {
                "threads": info.get("threads_per_block"), "ms": round(ms_, 6), "ms_device": round(dev_ms, 6),
                "ms_per_sweep": round(ms_ / row["sweeps_max"], 6),
                "ms_device_per_sweep": round(dev_ms / row["sweeps_max"], 6), "resources": info}
        rows[label] = row
    log = os.path.join(_build.BUILD_DIR, "solve.log")
    ptxas = ([ln.strip() for ln in open(log) if "registers" in ln or "spill" in ln or "smem" in ln]
             if on_card and os.path.exists(log) else [])
    emit({"phase": "timing_k5", "gpu": smi, "per_sweep": rows, "ptxas_solve_cu": ptxas,
          "threads_by_bucket": {f"{v}x{c}": kernels.solve_info(dev, c, v)["threads_per_block"]
                                for v, c in solver.shape_ladder()} if on_card else None})
    return rows


def run_host_half(dev, cfg, smi, budgets=(("becstress", 2, 60), ("bectoken", 3, 120)),
                  formula_widths=(8, 32, 96, 192), solve_flips=(0, 64, 4096)):
    """Phases 5-8: K6/K7 and K5 against their twins, the whole analysis
    (SymExecWrapper + fire_lasers) on becstress and BECToken, and the
    times of K5-K7. Returns the kernels line's entries for K5-K7."""
    import torch

    from mythril_tpu_torch.disassembler.asm import assemble
    from mythril_tpu_torch.laser.cuda import (
        _build, backend, convert, engine, inloop_solve, keccak, megakernel, solver, solver_cache, transfer,
    )
    from mythril_tpu_torch.laser.cuda.batch import StateBatch

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def diff(a, b):
        """max |a - b| over two tensors (0 when equal)."""
        if torch.equal(a, b):
            return 0
        return max(1, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))

    max_err = {"K5": 0, "K6": 0, "K7": 0}
    small = tuple(f for f in StateBatch._fields if f not in transfer._SKIP_DOWN and f not in transfer._BIG_DOWN)

    # ---- 5. K6 / K7 against their twins at cfg ---------------------------
    xfer_cases = compare_transfer(dev, cfg, max_err)

    # ---- 6. K5 against its twin ------------------------------------------
    k5_cases = compare_solve(dev, max_err, formula_widths, solve_flips)
    ladder = solver.shape_ladder()

    # ---- 7. the whole analysis -------------------------------------------
    from mythril_tpu_torch.analysis.security import fire_lasers
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
    from mythril_tpu_torch.ethereum.evmcontract import EVMContract
    from mythril_tpu_torch.obs import catalog as cat
    from mythril_tpu_torch.robustness import retry

    counters = {"K1": (engine, "launches"), "K1_steps": (engine, "steps_run"), "K2": (keccak, "launches"),
                "K3": (inloop_solve, "launches"), "K4": (megakernel, "launches"), "K5": (solver, "launches"),
                "K6": (transfer, "unpack_launches"), "K7": (transfer, "pack_launches")}

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    captured = []  # the first K5 batches of the main path (the strategy's warmup batch first)
    capturing = [False]
    uncompiled = []  # the first constraint set of an analysis that compiled to no CNF instance
    first_up, first_down = [], []
    feas_failures = [0]
    enqueue_s = [0.0]
    cnf = {"sets": 0, "none": 0, "trivial": 0, "instances": 0}  # what the analyses handed the solver
    warm = {"launches": {k: 0 for k in counters}, "s": 0.0}  # the strategy's own warmup, inside the main path
    in_warmup = [False]
    orig = (solver.solve, solver.feasibility_batch, megakernel.run_fused, transfer.batch_to_device,
            transfer.batch_to_host, solver.compile_cnf_batch, backend._do_warmup)

    def warm_rec(key, event):
        before, t = read_counts(), time.perf_counter()
        in_warmup[0] = True
        try:
            return orig[6](key, event)
        finally:
            in_warmup[0] = False
            warm["s"] += time.perf_counter() - t
            for k, v in read_counts().items():
                warm["launches"][k] += v - before[k]

    def cnf_rec(sets, *a, **k):
        out = orig[5](sets, *a, **k)
        if capturing[0] and not in_warmup[0]:
            if not uncompiled:
                uncompiled.extend(cs for cs, i in zip(sets, out) if i is None)
            cnf["sets"] += len(out)
            cnf["none"] += sum(i is None for i in out)
            cnf["trivial"] += sum(i is not None and i.trivial is not None for i in out)
            cnf["instances"] += sum(i is not None and i.trivial is None for i in out)
        return out

    def solve_rec(lits, nvars, is_input, warm, flips, seed, device="cuda"):
        out = orig[0](lits, nvars, is_input, warm, flips, seed, device=device)
        if capturing[0] and len(captured) < 4:
            captured.append((convert.solver_operands_to_numpy((lits, nvars, is_input, warm)), flips, seed,
                             [o.cpu().numpy() for o in out]))
        return out

    def feas_rec(*a, **k):
        try:
            return orig[1](*a, **k)
        except Exception:
            feas_failures[0] += 1
            raise

    def fused_rec(*a, **k):
        t = time.perf_counter()
        out = orig[2](*a, **k)
        enqueue_s[0] += time.perf_counter() - t
        return out

    def up_rec(np_batch, cfg_, device="cuda"):
        if not first_up and int(np_batch["alive"].sum()) > 1:
            first_up.append({k: v.copy() for k, v in np_batch.items()})
        return orig[3](np_batch, cfg_, device=device)

    def down_rec(st, n_shards=1):
        if not first_down and int(st.alive.sum()) > 1:
            first_down.append(StateBatch(*(x.clone() for x in st)))
        return orig[4](st, n_shards=n_shards)

    contracts = {
        "becstress": assemble(STRESS_SRC),
        "bectoken": assemble(open(os.path.join(HERE, "bench_contracts", "bectoken.asm")).read()),
    }
    e2e_counts = {k: 0 for k in counters}
    solver.solve, solver.feasibility_batch, megakernel.run_fused = solve_rec, feas_rec, fused_rec
    transfer.batch_to_device, transfer.batch_to_host = up_rec, down_rec
    solver.compile_cnf_batch, backend._do_warmup = cnf_rec, warm_rec
    k5_from_sets = 0
    handoff = HandoffProbe()
    try:
        for name, tx, budget in budgets:
            runtime = contracts[name]
            n = len(runtime)
            creation = assemble(
                f"PUSH2 {n}\nPUSH2 :code\nPUSH1 0x00\nCODECOPY\nPUSH2 {n}\nPUSH1 0x00\nRETURN\ncode:"
            ).hex() + runtime.hex()
            run_cfg = cfg
            for attempt in range(2):
                backend.DEFAULT_BATCH_CFG = run_cfg
                retry.BREAKER.reset()
                degraded0 = cat.DEGRADED_ROUNDS_TOTAL.value()
                feas_failures[0] = 0
                enqueue_s[0] = 0.0
                snap0 = solver_cache.GLOBAL.snapshot()
                warm["launches"], warm["s"] = {k: 0 for k in counters}, 0.0
                # the main path: the kernels are built (phase 1), and the
                # strategy warms its config itself, inside the run
                sync()
                zero_counts()
                capturing[0] = True
                t1 = time.time()
                handoff.start()
                try:
                    sym = SymExecWrapper(EVMContract(code=runtime.hex(), creation_code=creation, name=name),
                                         address=0x1234, strategy="cuda-batch", execution_timeout=budget,
                                         transaction_count=tx, max_depth=128)
                    issues = sorted({(i.swc_id, i.address) for i in fire_lasers(sym)})
                finally:
                    handoff.stop()
                sync()
                wall = time.time() - t1
                capturing[0] = False
                counts = read_counts()
                strat = backend.find_tpu_strategy(sym.laser.strategy)
                if strat.device_rounds > 0 or run_cfg.device_engage_after_s == 0.0:
                    break
                emit({"phase": "e2e_rerun", "contract": name, "reason": "finished on the host before the "
                      f"{run_cfg.device_engage_after_s} s engagement delay; rerun with device_engage_after_s=0.0"})
                run_cfg = run_cfg._replace(device_engage_after_s=0.0)
            backend.DEFAULT_BATCH_CFG = cfg
            snap = solver_cache.GLOBAL.snapshot()
            degraded = cat.DEGRADED_ROUNDS_TOTAL.value() - degraded0
            k5_from_sets += counts["K5"] - warm["launches"]["K5"]
            for k in e2e_counts:
                e2e_counts[k] += counts[k]
            expected, early = expected_issues("e2e", name, handoff.at)
            emit({"phase": "e2e", "contract": name, "tx": tx, "budget_s": budget,
                  "device_engage_after_s": run_cfg.device_engage_after_s, "handoff": handoff.at,
                  "handoff_before_loop": early, "issues": issues, "expected": expected, "wall_s": round(wall, 3),
                  "strategy_warmup_s": round(warm["s"], 3),
                  "device_rounds": strat.device_rounds, "fused_rounds": strat.fused_rounds,
                  "fused_syncs": strat.fused_syncs, "in_loop_unsat_kills": strat.in_loop_unsat_kills,
                  "device_steps_retired": strat.device_steps_retired, "device_wall_s": round(strat.device_wall_s, 3),
                  "run_fused_enqueue_s": round(enqueue_s[0], 3),
                  "run_fused_enqueue_share_of_wall": round(enqueue_s[0] / wall, 4) if wall else None,
                  "total_states": sym.laser.total_states,
                  "solver_cache": {k: snap[k] - snap0[k] for k in snap if isinstance(snap[k], (int, float))
                                   and isinstance(snap0.get(k), (int, float))},
                  "launches": counts, "launches_in_strategy_warmup": warm["launches"],
                  "degraded_rounds": strat.degraded_rounds, "degraded_rounds_total": degraded,
                  "breaker": retry.BREAKER.state(), "breaker_trips": retry.BREAKER.trips,
                  "device_solve_failures": feas_failures[0], "gpu": smi})
            if issues != expected:
                raise AssertionError(f"{name}: issues {issues}, expected {expected} (handoff {handoff.at})")
            if strat.device_rounds <= 0:
                raise AssertionError(f"{name}: no device round")
            missing = [k for k in ("K1", "K4", "K6", "K7") if counts[k] - warm["launches"][k] <= 0]
            if on_card and missing:
                raise AssertionError(f"{name}: kernels never launched in the analysis: {missing}")
            if (strat.degraded_rounds or degraded or retry.BREAKER.state() != "closed" or retry.BREAKER.trips
                    or feas_failures[0]):
                raise AssertionError(f"{name}: a round degraded or a device solve failed")
    finally:
        solver.solve, solver.feasibility_batch, megakernel.run_fused = orig[:3]
        transfer.batch_to_device, transfer.batch_to_host = orig[3:5]
        solver.compile_cnf_batch, backend._do_warmup = orig[5:]
        backend.DEFAULT_BATCH_CFG = cfg
    if on_card:
        never = [k for k, v in e2e_counts.items() if v <= 0 and k != "K2"]  # K1 hashes SHA3 itself
        if never:
            raise AssertionError(f"kernels the main path never launched: {never}")
    blast = None
    if uncompiled:  # how far past the caps the analyses' sets are
        inst = solver.compile_cnf(uncompiled[0], max_vars=1 << 40, max_clauses=1 << 40)
        blast = {"terms": len(uncompiled[0]), "blastable": inst is not None,
                 "vars": None if inst is None else int(inst.nvars),
                 "clauses": None if inst is None else int(inst.clause_arr.shape[0]),
                 "caps": [solver.MAX_VARS, solver.MAX_CLAUSES]}
    emit({"phase": "e2e_solver", "cnf": cnf, "k5_launches_main_path": e2e_counts["K5"],
          "k5_launches_from_analysis_sets": k5_from_sets, "first_uncompiled_set": blast})
    if k5_from_sets == 0:
        emit({"phase": "finding", "kernel": "K5", "text": f"K5's {e2e_counts['K5']} main-path launch(es) were "
              f"the strategy's own warmup batch: of the {cnf['sets']} constraint sets the analyses handed "
              f"the device solver, {cnf['none']} compiled to no CNF instance (past the caps or un-blastable) "
              f"and {cnf['trivial']} were trivial; the first such set blasts to {blast}"})
    for i, (ops_np, flips, seed, outs) in enumerate(captured):
        ops = convert.solver_operands_to_torch(ops_np, dev)
        t_out = solver.solve_plain(*ops, flips, seed)
        err = max(diff(torch.as_tensor(o, device=dev), t) for o, t in zip(outs, t_out))
        max_err["K5"] = max(max_err["K5"], err)
        emit({"phase": "compare", "kernel": "K5", "case": f"main-path batch {i}", "I": int(ops_np[0].shape[0]),
              "bucket": [int(ops_np[2].shape[1]), int(ops_np[0].shape[1])], "flips": flips, "err": err,
              "sweeps_max": int(outs[2].max())})
        if err:
            raise AssertionError(f"K5 differs from its twin on main-path batch {i}")

    # ---- 8. times on the card ----------------------------------------------
    def time_ms(fn, reps=20, spin=False):
        """Mean time of fn over reps: CUDA events around the reps back to
        back (the host's time in each call counts when the card waits for
        it), or, with ``spin``, around each call queued behind a spinning
        kernel (the device's work alone). The rehearsal reports host
        time, which is no device figure and is not kept."""
        fn()
        sync()
        reps = reps if on_card else 1
        if on_card and spin:
            total = 0.0
            for _ in range(reps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                sync()
                torch.cuda._sleep(2_000_000)
                e0.record()
                fn()
                e1.record()
                torch.cuda.synchronize()
                total += e0.elapsed_time(e1)
            return total / reps
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            torch.cuda.synchronize()
            return e0.elapsed_time(e1) / reps
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    def wall_ms(fn, reps=10):
        fn()
        sync()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t) * 1e3 / reps

    # K5 at the analysis's own shapes when it launched, else the smallest bucket at SOLVE_FLIPS
    if captured:
        ops_np, flips5, seed5, _outs = captured[0]
        ops5 = convert.solver_operands_to_torch(ops_np, dev)
    else:
        pick = [c for c in k5_cases if c[2] == backend.SOLVE_FLIPS][0]
        ops5, flips5, seed5 = pick[1], pick[2], pick[3]
    ms5 = time_ms(lambda: solver.solve(*ops5, flips5, seed5, device=dev))
    plain5 = time_ms(lambda: solver.solve_plain(*ops5, flips5, seed5), reps=3)
    I5, V5 = ops5[2].shape
    bytes5 = sum(t.numel() * t.element_size() for t in ops5) + I5 * (4 + V5 + 4)
    sweeps5 = solver.solve(*ops5, flips5, seed5, device=dev)[2]
    # K5 a sweep: at the main path's batch and at the largest bucket with
    # 64 instances, both at SOLVE_FLIPS
    big = [c for c in k5_cases if c[0] == ladder[-1] and c[1][0].shape[0] == 64 and c[2] == backend.SOLVE_FLIPS]
    k5_sweeps = time_solve_per_sweep(dev, smi, {"main_path": (ops5, flips5, seed5),
                                                "largest_bucket_I64": big[0][1:4]}, max_err)

    # K6/K7 at the first multi-lane batch the analysis uploaded/downloaded
    nb6 = first_up[0] if first_up else xfer_cases["tape_sliced"][0]
    st7 = first_down[0] if first_down else xfer_cases["alive_prefix"][2]
    parts6 = transfer.batch_parts(nb6, cfg)
    staged = transfer.stage(parts6, dev) if on_card else None
    segs6, shipped6 = transfer._up_spec(parts6)
    ship6 = int(sum(a.nbytes for a in shipped6))
    full6 = int(sum(s.rows * s.full for s in segs6))
    if on_card:
        ms6 = time_ms(lambda: transfer.unpack(staged))
        ms6_device = time_ms(lambda: transfer.unpack(staged), spin=True)
        plain6 = time_ms(lambda: transfer.unpack_plain(staged.buf, segs6), reps=5)
        link_up = wall_ms(lambda: transfer.stage(parts6, dev))
        host_buf = torch.empty(staged.buf.numel(), dtype=torch.uint8, pin_memory=True)
        pinned_up = time_ms(lambda: staged.buf.copy_(host_buf, non_blocking=True))

        def per_plane_up():
            for s_, plane in zip(segs6, staged.planes):
                if s_.ship:
                    src = staged.buf[s_.src_off: s_.src_off + s_.rows * s_.ship]
                    plane.view(-1).view(torch.uint8).view(s_.rows, s_.full)[:, : s_.ship].copy_(
                        src.view(s_.rows, s_.ship))
        per_plane6 = time_ms(per_plane_up)
    else:
        ms6 = ms6_device = plain6 = time_ms(lambda: transfer.upload(parts6, dev))
        link_up = pinned_up = per_plane6 = None
    bytes6 = ship6 + full6  # the shipped bytes read, every plane written

    a7 = st7.alive.cpu().numpy()
    t7, l7 = transfer.down_plan(st7.tape_len.cpu().numpy(), a7, cfg.tape_slots)
    calls7 = {"small": (small, None, None), "big": (transfer._BIG_DOWN, t7, l7)}
    ms7 = time_ms(lambda: (transfer.pack(st7, small), transfer.pack(st7, transfer._BIG_DOWN, t7, l7)))
    plain7 = time_ms(lambda: (transfer.pack_plain(st7, small), transfer.pack_plain(st7, transfer._BIG_DOWN, t7, l7)),
                     reps=5)
    outs7 = {c: transfer.pack(st7, *a) for c, a in calls7.items()}
    down_bytes = sum(o.numel() for o in outs7.values())
    bytes7 = 2 * down_bytes

    # K7's yardstick: one torch.cat of the same byte views (bools as u8);
    # a tape plane sliced to its used columns has no flat view, so its
    # part is flattened (a copy) inside the call, as PyTorch must
    def cat_parts(fields, t_, l_):
        parts = []
        for f in fields:
            x = getattr(st7, f)
            if t_ is not None and f in transfer._TAPE_PLANES:
                x = x[:, : transfer._tape_cols(f, t_)]
            if l_ is not None:
                x = x[:l_]
            parts.append(x.view(torch.uint8))
        return parts

    views7 = {c: cat_parts(*a) for c, a in calls7.items()}
    for c, v in views7.items():
        if not torch.equal(torch.cat([p.reshape(-1) for p in v]), outs7[c]):
            raise AssertionError(f"torch.cat of the {c} download's views differs from K7's output")
    k7_by_call = {}
    for c, a in calls7.items():
        k7_by_call[c] = {
            "bytes": int(outs7[c].numel()),
            "sliced_parts": sum(not p.is_contiguous() for p in views7[c]),
            "ms": round(time_ms(lambda: transfer.pack(st7, *a)), 6),
            "ms_device": round(time_ms(lambda: transfer.pack(st7, *a), spin=True), 6),
            "library_ms": round(time_ms(lambda: torch.cat([p.reshape(-1) for p in views7[c]])), 6),
            "library_ms_device": round(time_ms(lambda: torch.cat([p.reshape(-1) for p in views7[c]]), spin=True),
                                       6),
            "bound_ms": round(2 * outs7[c].numel() / HBM_BYTES_PER_S * 1e3, 9),
        }
    library7 = sum(k["library_ms"] for k in k7_by_call.values())
    log = os.path.join(_build.BUILD_DIR, "transfer.log")
    xfer_ptxas = ([ln.strip() for ln in open(log) if "registers" in ln or "spill" in ln]
                  if on_card and os.path.exists(log) else [])
    if on_card:
        link_down = wall_ms(lambda: transfer.batch_to_host(st7))
        dev_buf = torch.cat([outs7["small"], outs7["big"]])
        host7 = torch.empty(dev_buf.numel(), dtype=torch.uint8, pin_memory=True)
        pinned_down = time_ms(lambda: host7.copy_(dev_buf, non_blocking=True))
        scratch7 = torch.empty(down_bytes, dtype=torch.uint8, device=dev)

        def per_plane_down():
            off = 0
            for fields, t_, l_ in ((small, None, None), (transfer._BIG_DOWN, t7, l7)):
                for f in fields:
                    x = getattr(st7, f)
                    rows, ship, srow = transfer._down_cut(x, f, t_, l_)
                    xb = x.view(-1).view(torch.uint8).view(x.shape[0], srow)
                    scratch7[off: off + rows * ship].view(rows, ship).copy_(xb[:rows, :ship])
                    off += rows * ship
        per_plane7 = time_ms(per_plane_down)
    else:
        link_down = pinned_down = per_plane7 = None

    emit({"phase": "timing_host_half", "gpu": smi,
          "K5": {"I": int(I5), "V": int(V5), "C": int(ops5[0].shape[1]), "flips": flips5,
                 "from_main_path": bool(captured), "sweeps_max": int(sweeps5.max()),
                 "sweeps_mean": round(float(sweeps5.float().mean()), 3), "bytes": int(bytes5)},
          "K5_sweeps_by_bucket": {f"{b[0]}x{b[1]}/I{int(o[0].shape[0])}/f{f}": int(sw.max())
                                  for b, o, f, _s, sw in k5_cases},
          "K6": {"from_analysis": bool(first_up), "shipped_bytes": ship6, "plane_bytes": full6,
                 "segments": int(len(staged.table)) if on_card else None,
                 "upload_link_ms": link_up, "pinned_copy_ms": pinned_up, "per_plane_copy_ms": per_plane6},
          "K7": {"from_analysis": bool(first_down), "t_used": t7, "l_used": l7, "downloaded_bytes": int(down_bytes),
                 "by_call": k7_by_call,
                 "batch_to_host_ms": link_down, "pinned_copy_ms": pinned_down, "per_plane_copy_ms": per_plane7},
          "K6/K7 ptxas": xfer_ptxas})

    def entry(kid, name, source, replaces, ms, plain, nbytes, library=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": e2e_counts[kid], "max_abs_err": max_err[kid], "ms": round(ms, 6),
                "plain_ms": round(plain, 6), "bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 9),
                "bound_by": "bytes", "library_ms": None if library is None else round(library, 6)}

    # ms: CUDA events around back-to-back calls, as for every kernel here
    # (K7: the two calls of a download); ms_device: each call queued
    # behind a spinning kernel. K6 has no library call: none writes
    # padded, zero-filled planes from one packed buffer. K7's library_ms
    # is torch.cat of the same byte views, a call per download.
    return [
        dict(entry("K5", "K5 solve", "mythril_tpu_torch/csrc/solve.cu", "mythril_tpu/laser/tpu/solver_jax.py:457",
                   ms5, plain5, bytes5), sweeps_max=int(sweeps5.max()), ms_per_sweep=round(ms5 / int(sweeps5.max()), 6),
             largest_bucket_I64={k: v for k, v in k5_sweeps["largest_bucket_I64"].items() if k != "bytes"}),
        dict(entry("K6", "K6 unpack", "mythril_tpu_torch/csrc/transfer.cu", "mythril_tpu/laser/tpu/transfer.py:236",
                   ms6, plain6, bytes6), ms_device=round(ms6_device, 6)),
        dict(entry("K7", "K7 pack", "mythril_tpu_torch/csrc/transfer.cu", "mythril_tpu/laser/tpu/transfer.py:410",
                   ms7, plain7, bytes7, library7),
             ms_device_by_call={c: k["ms_device"] for c, k in k7_by_call.items()},
             library_ms_device_by_call={c: k["library_ms_device"] for c, k in k7_by_call.items()}),
    ]

# Runs `python -m mythril_tpu_torch <argv[2:]>` in this process and writes
# the kernels' launch counts (zeroed just before the CLI starts) and the
# device opcode profile the analysis recorded to the file argv[1], just
# before the CLI's own exit check.
CLI_RUNNER = r"""
import json, runpy, sys
from chip_smoke import launch_counters
from mythril_tpu_torch.interfaces import cli
from mythril_tpu_torch.laser.evm.iprof import InstructionProfiler
zero_counts, read_counts = launch_counters()
out_path = sys.argv[1]
sys.argv = ["mythril_tpu_torch"] + sys.argv[2:]
profile = {"counts": {}, "rounds": 0, "wall_s": 0.0}
record = InstructionProfiler.record_device_round
def record_device_round(self, counts, wall_time):
    for op, n in counts.items():
        profile["counts"][op] = profile["counts"].get(op, 0) + n
    profile["rounds"] += 1
    profile["wall_s"] += wall_time
    record(self, counts, wall_time)
InstructionProfiler.record_device_round = record_device_round
exit_check = cli._hard_exit_if_compiling
def dump_then_exit_check(code):
    with open(out_path, "w") as fh:
        json.dump({"launches": read_counts(), "profile": profile}, fh)
    exit_check(code)
cli._hard_exit_if_compiling = dump_then_exit_check
zero_counts()
runpy.run_module("mythril_tpu_torch", run_name="__main__", alter_sys=True)
"""


def phase9(dev, cfg, fused_twins, hist_steps=64, slice_steps=512):
    """Phase 9: K8, K9 and K1's stats instance against their twins, and
    the one-launch loops (a sync slice, a fused round with stats) against
    the twins' loops; the stats super-round runs on the main path's
    inputs against the twin that phase 3 ran with stats on them
    (``fused_twins``, as ``run`` returns it). Returns a namespace: ``max_err`` (K8's and K9's own
    compares only), ``k1_err`` (K1's planes and histogram in the stats,
    slice and fused compares), the inputs that K8's and K9's timing
    reuses, and the slice's and super-round's walls."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from mythril_tpu_torch.disassembler.asm import assemble
    from mythril_tpu_torch.laser.cuda import batch, engine, inloop_solve, kernels, megakernel

    on_card = dev.type == "cuda"
    zero_counts, read_counts = launch_counters()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def diff(a, b):
        if torch.equal(a, b):
            return 0
        return max(1, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))

    def batch_diff(a, b):
        for name, x, y in zip(batch.StateBatch._fields, a, b):
            if not torch.equal(x, y):
                idx = (x != y).nonzero()[0].tolist()
                return diff(x, y), f"{name}{idx}: kernel={x[tuple(idx)].item()} twin={y[tuple(idx)].item()}"
        return 0, None

    max_err = {"K8": 0, "K9": 0}
    k1_err = 0
    rng = np.random.default_rng(20261018)
    sym = dict(symbolic_calldata=True, symbolic_storage=True, symbolic_caller=True, symbolic_callvalue=True)

    def seeds(n_sym, n_conc):
        specs = [dict(sym) for _ in range(n_sym)]
        for i in range(n_conc):
            cd = int(rng.integers(1, 2**31)).to_bytes(32, "big") + int(rng.integers(0, 6)).to_bytes(32, "big")
            specs.append(dict(calldata=cd + bytes(rng.integers(0, 256, 64, dtype=np.uint8)), caller=0x1000 + i))
        return specs

    contracts = {
        "becstress": assemble(STRESS_SRC),
        "bectoken": assemble(open(os.path.join(HERE, "bench_contracts", "bectoken.asm")).read()),
    }

    def bank_for(code):
        return batch.make_code_bank([code], cfg.code_len, host_ops=ALWAYS_HOST, freeze_errors=True,
                                    record_storage_events=True, prune_revert=True, device=dev)

    # ---- 9. K8 and K9 against their twins, and K1's stats instance ----------
    cb_t = bank_for(contracts["bectoken"])
    n_cmp = min(32, cfg.lanes // 8)
    st0 = st_k = st_t = batch.build_batch(cfg, seeds(n_cmp, n_cmp), device=dev)
    hist_k = torch.zeros(256, dtype=torch.int32, device=dev)
    hist_t = hist_k.clone()
    stale = 0
    for i in range(hist_steps):
        nk = engine.step(cb_t, None, st_k, device=dev)
        nt = engine.step_plain(cb_t, st_t)
        stale += int((~st_t.alive & nt.alive & (nt.steps > st_t.steps)).sum())
        hist_k = engine.op_hist_update(cb_t, st_k, nk, hist_k, device=dev)
        hist_t = engine.op_hist_update_plain(cb_t, st_t, nt, hist_t)
        err, where = batch_diff(nk, nt)
        max_err["K8"] = max(max_err["K8"], diff(hist_k, hist_t))
        if err or max_err["K8"]:
            raise AssertionError(f"K8 (or K1) differs from the twin at step {i}: {where} "
                                 f"hist err {max_err['K8']}")
        prev_k, st_k, st_t = st_k, nk, nt
    emit({"phase": "compare", "kernel": "K8", "contract": "bectoken", "steps": hist_steps, "lanes": cfg.lanes,
          "retired": int(hist_k.to(torch.int64).sum()), "stale_lane_children": stale, "ok": True})
    if stale <= 0:
        raise AssertionError("no fork child counted its stale lane's opcode: the quirk went unexercised")

    # K1's stats instance: the same 64 steps in one launch, its histogram
    # seeded near 2^32 so that bins wrap, against the twin's steps and K8
    # twin; on the lanes' own grid, one block (several lanes a thread) and
    # 8 blocks; then a launch the loop's control word stops
    seed_h = torch.full((256,), -3, dtype=torch.int32, device=dev)  # 2^32 - 3 in every bin
    want_h = seed_h.clone()
    s_t = st0
    for _ in range(hist_steps):
        n_t = engine.step_plain(cb_t, s_t)
        want_h = engine.op_hist_update_plain(cb_t, s_t, n_t, want_h)
        s_t = n_t
    wrapped = int(((want_h.to(torch.int64) & engine.M32) < (seed_h.to(torch.int64) & engine.M32)).sum())
    k1_stats = {}
    for blocks in ((0, 1, 8) if on_card else (0,)):
        s = batch.StateBatch(*(x.clone() for x in st0))
        h = seed_h.clone()
        if on_card:
            kernels.launch_step_run(kernels.StepArgs(cb_t, s), hist_steps, blocks=blocks, hist=h)
        else:
            s = engine.step_n(cb_t, None, s, hist_steps, device=dev, hist=h)
        err, where = batch_diff(s, s_t)
        err_h = diff(h, want_h)
        k1_err = max(k1_err, err, err_h)
        k1_stats[f"blocks_{blocks or 'auto'}"] = {"plane_err": err, "hist_err": err_h}
        if err or err_h:
            raise AssertionError(f"K1's stats instance (blocks={blocks}) differs from the twin: {where}, "
                                 f"hist err {err_h}")
    s = batch.StateBatch(*(x.clone() for x in st0))
    h = seed_h.clone()
    engine.step_n(cb_t, None, s, hist_steps, device=dev, ctl=torch.tensor([3, 0, 0, 0], dtype=torch.int32,
                                                                          device=dev), inplace=True, hist=h)
    stopped_ok = diff(h, seed_h) == 0 and batch_diff(s, st0)[0] == 0
    emit({"phase": "compare", "kernel": "K1 with stats", "contract": "bectoken", "steps": hist_steps,
          "lanes": cfg.lanes, "grids": k1_stats, "bins_wrapped": wrapped, "stopped_launch_adds_nothing": stopped_ok,
          "ok": bool(stopped_ok and wrapped > 0)})
    if not stopped_ok or wrapped <= 0:
        raise AssertionError(f"K1's stats instance: a stopped launch changed something ({not stopped_ok}) "
                             f"or no bin wrapped ({wrapped})")

    n_seeds = min(16, cfg.lanes // 4)
    specs = [dict(sym) for _ in range(n_seeds // 2)] + seeds(0, n_seeds // 2)
    cb_s, st_s = bank_for(contracts["bectoken"]), batch.build_batch(cfg, specs, device=dev)
    out_t, ht = engine.run_plain(cb_s, st_s, slice_steps, True)
    walls, slice_counts = {}, {}
    for with_stats in (True, False):
        label = "stats" if with_stats else "plain"
        sync()
        zero_counts()
        t0 = time.perf_counter()
        if with_stats:
            out_k, hk = engine.run_with_stats(cb_s, None, st_s, max_steps=slice_steps, device=dev)
        else:
            out_k = engine.run(cb_s, None, st_s, max_steps=slice_steps, device=dev)
        t_enq = time.perf_counter()
        sync()
        walls[label] = {"wall_ms": round((time.perf_counter() - t0) * 1e3, 3),
                        "enqueue_ms": round((t_enq - t0) * 1e3, 3)}
        slice_counts[label] = read_counts()
        err_h = diff(hk, ht) if with_stats else 0
        err, where = batch_diff(out_k, out_t)
        k1_err = max(k1_err, err, err_h)
        if err or err_h:
            raise AssertionError(f"the slice loop differs from the twin (stats={with_stats}): {where}, "
                                 f"hist err {err_h}")
        c = slice_counts[label]
        if on_card and (c["K1"] != 1 or c["K1_stats"] != int(with_stats) or c["K8"] or c["K9"]):
            raise AssertionError(f"a slice (stats={with_stats}) did not run as one K1 launch: {c}")
    emit({"phase": "compare", "kernel": "slice loop (one K1 launch)", "contract": "bectoken",
          "max_steps": slice_steps, "lanes": cfg.lanes, "steps_max": int(out_t.steps.max()),
          "alive": int(out_t.alive.sum()), "retired": int(ht.to(torch.int64).sum()), "slice": walls,
          "launches": slice_counts, "ok": True})

    # K9, the backend's quiescence read, against its twin: the whole control
    # word from a fresh, a running, a stopped and a spent word, with
    # max_steps 0, below t, at the spent word's t and above, on the slice's
    # input and output, a batch with no lane alive, one whose lanes are all
    # alive and none RUNNING, and one whose last lane alone runs; and
    # engine.any_running (one K9 and a fetch) on each against the twin
    last_lane = torch.arange(cfg.lanes, device=dev) == cfg.lanes - 1
    stopped = torch.full_like(st_s.status, batch.STOPPED)
    k9_batches = {
        "slice_in": st_s, "slice_out": out_k,
        "none_alive": st_s._replace(alive=torch.zeros_like(st_s.alive)),
        "none_running": st_s._replace(alive=torch.ones_like(st_s.alive), status=stopped),
        "last_lane_running": st_s._replace(alive=last_lane.to(st_s.alive.dtype),
                                           status=torch.where(last_lane, batch.RUNNING, stopped)),
    }
    words = ([0, 0, 0, 7], [5, 1, 1, 7], [5, 0, 1, 7], [512, 1, 0, 7])
    limits = (0, 3, 512, 4096)
    k9 = {}
    for label, s in k9_batches.items():
        errs = []
        for word in words:
            for max_steps in limits:
                ck = torch.tensor(word, dtype=torch.int32, device=dev)
                ct = ck.clone()
                engine.slice_ctl(s, ck, max_steps, device=dev)
                engine.slice_ctl_plain(s, ct, max_steps)
                errs.append(diff(ck, ct))
        running_t = bool((s.alive & (s.status == batch.RUNNING)).any())
        running_k = engine.any_running(s, device=dev)
        max_err["K9"] = max(max_err["K9"], *errs)
        k9[label] = {"running": running_t, "ctl_err": max(errs), "any_running_agrees": running_k == running_t}
        if max(errs) or running_k != running_t:
            raise AssertionError(f"K9 differs from the twin on {label}: {k9[label]}")
    if {v["running"] for v in k9.values()} != {True, False}:
        raise AssertionError(f"K9's batches were not both running and quiescent: {k9}")
    emit({"phase": "compare", "kernel": "K9", "lanes": cfg.lanes, "words": words, "max_steps": limits,
          "batches": k9, "ok": True})

    pool0 = inloop_solve.empty_pool(dev)
    fused_walls = {}
    for name, (cb_f, st_f, rounds, steps_per_round, ft) in fused_twins.items():
        fused_walls[name] = {}
        for with_stats in (False, True):
            sync()
            zero_counts()
            t0 = time.perf_counter()
            fo = megakernel.run_fused(cb_f, None, st_f, max_rounds=rounds, steps_per_round=steps_per_round,
                                      with_stats=with_stats, with_solve=True, pool=pool0, device=dev)
            t_enq = time.perf_counter()
            info = megakernel.decode_info(fo.info)
            c = read_counts()
            fused_walls[name]["stats_on" if with_stats else "stats_off"] = {
                "wall_ms": round((time.perf_counter() - t0) * 1e3, 3), "enqueue_ms": round((t_enq - t0) * 1e3, 3),
                "rounds": info.rounds, "launches": {k: c[k] for k in ("K1", "K1_stats", "K8", "K3", "K4")}}
            if on_card and (c["K1"] != rounds or c["K1_stats"] != (rounds if with_stats else 0) or c["K8"]):
                raise AssertionError(f"{name}: run_fused(with_stats={with_stats}) did not run one K1 launch a "
                                     f"round: {c}")
        err, where = batch_diff(fo.st, ft.st)
        err_h = diff(fo.hist, ft.hist)
        k1_err = max(k1_err, err, err_h)
        ok = not err and not err_h and torch.equal(fo.info, ft.info) and torch.equal(fo.pruned_visited,
                                                                                     ft.pruned_visited)
        emit({"phase": "compare", "kernel": "run_fused with stats", "contract": name, "info": ft.info.tolist(),
              "retired": int(ft.hist.to(torch.int64).sum()), "super_round": fused_walls[name], "ok": bool(ok)})
        if not ok:
            raise AssertionError(f"{name}: run_fused(with_stats=True) differs from the twin: {where}, "
                                 f"hist err {err_h}")
    return SimpleNamespace(max_err=max_err, k1_err=k1_err, contracts=contracts, k8_state=(cb_t, prev_k, st_k),
                           slice_state=st_s, walls=walls, fused_walls=fused_walls)


def run_stats_and_sync(dev, cfg, smi, fused_twins, cli_budget=60, sync_budget=("bectoken", 3, 120),
                       slice_steps=512):
    """Phases 9-11: phase9() (``fused_twins`` from ``run``), the CLI
    with --enable-iprof in a subprocess, the sync slice loop end to end,
    and the times of K8 and K9. Returns
    the kernels line's entries for K8 and K9, and K1's largest plane or
    histogram error in phase 9's compares."""
    import tempfile

    import torch

    from mythril_tpu_torch.analysis.security import fire_lasers
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
    from mythril_tpu_torch.disassembler.asm import assemble
    from mythril_tpu_torch.ethereum.evmcontract import EVMContract
    from mythril_tpu_torch.laser.cuda import backend, engine, kernels
    from mythril_tpu_torch.obs import catalog as cat
    from mythril_tpu_torch.robustness import retry

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    p9 = phase9(dev, cfg, fused_twins, slice_steps=slice_steps)
    max_err, contracts = p9.max_err, p9.contracts
    zero_counts, read_counts = launch_counters()

    # ---- 10. the CLI with --enable-iprof, a subprocess ---------------------
    runtime = contracts["becstress"]
    n = len(runtime)
    creation = assemble(
        f"PUSH2 {n}\nPUSH2 :code\nPUSH1 0x00\nCODECOPY\nPUSH2 {n}\nPUSH1 0x00\nRETURN\ncode:"
    ).hex() + runtime.hex()
    cli_argv = ["-v", "3", "analyze", "-c", creation, "--no-onchain-data", "--strategy", "cuda-batch",
                "-t", "2", "--execution-timeout", str(cli_budget), "--enable-iprof", "-o", "json",
                "--device", dev.type]
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "mythril_tpu_torch", "_build")) as tmp:
        counts_path = os.path.join(tmp, "cli_counts.json")
        env = dict(os.environ, MYTHRIL_DIR=tmp, PYTHONPATH=HERE)
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-c", CLI_RUNNER, counts_path, *cli_argv], capture_output=True,
                              text=True, timeout=cli_budget + 600, cwd=HERE, env=env)
        cli_wall = time.time() - t0
        if proc.returncode != 0 or not os.path.exists(counts_path):
            raise AssertionError(f"the CLI failed (rc {proc.returncode}): {proc.stderr[-4000:]}")
        rec = json.load(open(counts_path))
    report = json.loads(proc.stdout)
    cli_issues = sorted({(i["swc-id"], i["address"]) for i in report["issues"]})
    cli_launches, profile = rec["launches"], rec["profile"]
    emit({"phase": "e2e_cli", "contract": "becstress", "argv": cli_argv[:4] + ["<creation hex>"] + cli_argv[5:],
          "issues": cli_issues, "expected": EXPECTED_ISSUES["becstress"], "wall_s": round(cli_wall, 3),
          "launches": cli_launches, "device_rounds_profiled": profile["rounds"],
          "device_profile_wall_s": round(profile["wall_s"], 3),
          "device_retired": sum(profile["counts"].values()),
          "device_top_ops": sorted(profile["counts"].items(), key=lambda kv: -kv[1])[:8],
          "profile_printed": "Device rounds:" in proc.stderr, "gpu": smi})
    if cli_issues != [tuple(x) for x in EXPECTED_ISSUES["becstress"]]:
        raise AssertionError(f"CLI: issues {cli_issues}, expected {EXPECTED_ISSUES['becstress']}")
    if not profile["counts"] or "Device rounds:" not in proc.stderr:
        raise AssertionError("the CLI reported no device opcode profile")
    # K1's stats instance folds the histogram: no K8 launch; K9 is only
    # the sync tier's quiescence read between slices
    missing = [k for k in ("K1", "K1_steps", "K1_stats", "K3", "K4", "K6", "K7") if cli_launches[k] <= 0]
    if on_card and (missing or cli_launches["K8"]):
        raise AssertionError(f"kernels the CLI path never launched: {missing}, or K8 launched: {cli_launches}")

    # ---- 11. the sync slice loop end to end ----------------------------------
    name, tx, budget = sync_budget
    runtime = contracts[name]
    n = len(runtime)
    creation = assemble(
        f"PUSH2 {n}\nPUSH2 :code\nPUSH1 0x00\nCODECOPY\nPUSH2 {n}\nPUSH1 0x00\nRETURN\ncode:"
    ).hex() + runtime.hex()
    fused_env = os.environ.get("MYTHRIL_TPU_FUSED")
    os.environ["MYTHRIL_TPU_FUSED"] = "off"
    try:
        retry.BREAKER.reset()
        degraded0 = cat.DEGRADED_ROUNDS_TOTAL.value()
        slices0 = cat.DEVICE_SLICES_TOTAL.value()
        sync()
        zero_counts()
        t1 = time.time()
        handoff = HandoffProbe()
        handoff.start()
        try:
            sym = SymExecWrapper(EVMContract(code=runtime.hex(), creation_code=creation, name=name),
                                 address=0x1234, strategy="cuda-batch", execution_timeout=budget,
                                 transaction_count=tx, max_depth=128)
            issues = sorted({(i.swc_id, i.address) for i in fire_lasers(sym)})
        finally:
            handoff.stop()
        sync()
        wall = time.time() - t1
        sync_launches = read_counts()
    finally:
        if fused_env is None:
            os.environ.pop("MYTHRIL_TPU_FUSED", None)
        else:
            os.environ["MYTHRIL_TPU_FUSED"] = fused_env
    strat = backend.find_tpu_strategy(sym.laser.strategy)
    slices = cat.DEVICE_SLICES_TOTAL.value() - slices0
    degraded = cat.DEGRADED_ROUNDS_TOTAL.value() - degraded0
    expected, early = expected_issues("e2e_sync", name, handoff.at)
    emit({"phase": "e2e_sync", "contract": name, "tx": tx, "budget_s": budget, "handoff": handoff.at,
          "handoff_before_loop": early, "issues": issues,
          "expected": expected, "wall_s": round(wall, 3), "device_rounds": strat.device_rounds,
          "device_slices": slices, "fused_rounds": strat.fused_rounds,
          "device_steps_retired": strat.device_steps_retired, "device_wall_s": round(strat.device_wall_s, 3),
          "total_states": sym.laser.total_states, "launches": sync_launches,
          "degraded_rounds": strat.degraded_rounds, "degraded_rounds_total": degraded,
          "breaker": retry.BREAKER.state(), "gpu": smi})
    if issues != expected:
        raise AssertionError(f"{name} (sync slices): issues {issues}, expected {expected} (handoff {handoff.at})")
    if strat.device_rounds <= 0 or slices <= 0 or strat.fused_rounds:
        raise AssertionError(f"{name}: the sync slice loop ran no device slice")
    if strat.degraded_rounds or degraded or retry.BREAKER.state() != "closed":
        raise AssertionError(f"{name}: a round degraded under the sync slice loop")
    missing = [k for k in ("K1", "K6", "K7", "K9") if sync_launches[k] <= 0]
    if on_card and missing:
        raise AssertionError(f"kernels the sync path never launched: {missing}")

    # ---- times of K8 and K9 ---------------------------------------------------
    def time_ms(fn, reps=50):
        fn()
        sync()
        reps = reps if on_card else 1
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            torch.cuda.synchronize()
            return e0.elapsed_time(e1) / reps
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    # through their engine entry points, as every other row is timed; and
    # the launch alone, its arguments built once (launch_ms)
    cb8, before8, after8 = p9.k8_state
    h8 = torch.zeros(256, dtype=torch.int32, device=dev)
    ms8 = time_ms(lambda: engine.op_hist_update(cb8, before8, after8, h8, device=dev))
    launch8 = None
    if on_card:
        a8 = kernels.HistArgs(cb8, before8, after8, h8)
        launch8 = time_ms(lambda: kernels.launch_op_hist(a8))
    plain8 = time_ms(lambda: engine.op_hist_update_plain(cb8, before8, after8, h8), reps=10)
    L = cfg.lanes
    counted = int((after8.steps > before8.steps).sum())
    bytes8 = L * (3 * 4 + 4) + counted + 2 * 256 * 4
    st_s = p9.slice_state
    ctl9 = torch.zeros(4, dtype=torch.int32, device=dev)
    ms9 = time_ms(lambda: engine.slice_ctl(st_s, ctl9, slice_steps, device=dev))
    launch9 = None
    if on_card:
        a9 = kernels.SliceArgs(st_s, ctl9, slice_steps)
        launch9 = time_ms(lambda: kernels.launch_slice_ctl(a9))
    plain9 = time_ms(lambda: engine.slice_ctl_plain(st_s, ctl9, slice_steps), reps=10)
    bytes9 = L * (1 + 4) + 2 * 4 * 4
    emit({"phase": "timing_stats_and_sync", "gpu": smi, "K8": {"lanes": L, "counted_lanes": counted},
          "K9": {"lanes": L}, "slice_512": p9.walls, "super_round": p9.fused_walls,
          "K1_stats_instance": kernels.step_run_info(dev, stats=True) if on_card else None})

    def entry(kid, name, source, replaces, launches, ms, launch_ms, plain, nbytes, by_path):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": by_path, "max_abs_err": max_err[kid],
                "ms": round(ms, 6), "launch_ms": None if launch_ms is None else round(launch_ms, 6),
                "plain_ms": round(plain, 6),
                "bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 9), "bound_by": "bytes", "library_ms": None}

    # K1's stats instance took K8's place on the loops, and one K1 launch
    # a slice K9's: beside each path's K8 and K9 launches, its K1 launches
    # with stats and in all
    by_path8 = {"e2e_cli": cli_launches["K8"], "e2e_sync": sync_launches["K8"]}
    by_path9 = {"e2e_cli": cli_launches["K9"], "e2e_sync": sync_launches["K9"]}
    k1_by_path = {"e2e_cli": {"K1": cli_launches["K1"], "K1_stats": cli_launches["K1_stats"]},
                  "e2e_sync": {"K1": sync_launches["K1"], "K1_stats": sync_launches["K1_stats"]}}
    if on_card and (cli_launches["K1_stats"] <= 0 or cli_launches["K8"] or sync_launches["K9"] <= 0):
        raise AssertionError(f"K1's stats instance never launched on the CLI path, K8 did, or the sync path "
                             f"read no quiescence: {by_path8} {by_path9} {k1_by_path}")
    return [
        dict(entry("K8", "K8 op_hist_update", "mythril_tpu_torch/csrc/hist.cu",
                   "mythril_tpu/laser/tpu/engine.py:1398", cli_launches["K8"], ms8, launch8, plain8, bytes8, by_path8),
             k1_launches_by_path=k1_by_path),
        dict(entry("K9", "K9 slice_ctl", "mythril_tpu_torch/csrc/slice.cu",
                   "mythril_tpu/laser/tpu/engine.py:1415", sync_launches["K9"], ms9, launch9, plain9, bytes9, by_path9),
             k1_launches_by_path=k1_by_path),
    ], p9.k1_err


LOOP_SRC = "here:\nJUMPDEST\nPUSH1 :here\nJUMP"


def tensor_diff(a, b):
    """0 where two tensors are equal, else their largest difference (at least 1)."""
    import torch

    if torch.equal(a, b):
        return 0
    return max(1, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))


def batch_diff(a, b):
    """(error, where) of the first plane where two batches differ, (0, None) where none does."""
    from mythril_tpu_torch.laser.cuda import batch

    for name, x, y in zip(batch.StateBatch._fields, a, b):
        if not x.equal(y):
            idx = (x != y).nonzero()[0].tolist()
            return tensor_diff(x, y), f"{name}{idx}: kernel={x[tuple(idx)].item()} twin={y[tuple(idx)].item()}"
    return 0, None


def clone_batch(st):
    from mythril_tpu_torch.laser.cuda import batch

    return batch.StateBatch(*(x.clone() for x in st))


def events_ms(dev, fn, prep=None, reps=20, spin=False):
    """Mean time of ``fn(prep())`` over reps, CUDA events around the call,
    the inputs made by ``prep`` outside the timed region; with ``spin``
    each call is queued behind a spinning kernel, so the events time the
    device's own work and not the host's launch. Host time on the CPU
    (no device figure, not kept)."""
    import torch

    on_card = dev.type == "cuda"
    fn(prep() if prep else None)
    if on_card:
        torch.cuda.synchronize()
    total = 0.0
    reps = reps if on_card else 1
    for _ in range(reps):
        a = prep() if prep else None
        if not on_card:
            t = time.perf_counter()
            fn(a)
            total += (time.perf_counter() - t) * 1e3
            continue
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(2_000_000)
        e0.record()
        fn(a)
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


STEAL_SHAPES = [(lanes, n) for lanes in (64, 160, 512, 1024) for n in (1, 2, 8, 64) if lanes % n == 0]
STEAL_KINDS = ("skew", "capacity", "ragged", "idle", "all_running", "full_receivers")


def tagged_batch(cfg, dev, n, running, halted=0):
    """A batch at cfg whose rows carry their lane index, over n shards:
    ``running[s]`` running lanes, then ``halted`` (an int, or one a
    shard) halted ones, as a dense prefix of shard s."""
    import torch

    from mythril_tpu_torch.laser.cuda import batch

    L = cfg.lanes
    per = L // n
    halted = [halted] * n if isinstance(halted, int) else halted
    st = batch.empty_batch(cfg, device=dev)
    alive = torch.zeros(L, dtype=torch.bool, device=dev)
    status = torch.full((L,), batch.STOPPED, dtype=torch.int32, device=dev)
    for s, (c, h) in enumerate(zip(running, halted)):
        alive[s * per: s * per + c + h] = True
        status[s * per: s * per + c] = batch.RUNNING
    lane = torch.arange(L, dtype=torch.int32, device=dev)
    stack = st.stack.clone()
    stack[:, 0] = lane
    visited = torch.zeros_like(st.visited)
    visited[torch.arange(L, device=dev), lane.long() % cfg.code_len] = True
    return st._replace(alive=alive, status=status, pc=lane + 100, steps=lane + 1000, gas_left=lane + 5000,
                       static_pruned=torch.full_like(lane, 7), stack=stack, visited=visited)


def steal_case(cfg, dev, lanes, n, kind, rng):
    """The steal kernel's compare batches: ``skew`` (shards 0-1 full of
    running lanes: the skew demos' steal), ``capacity`` (shards 0-1 half
    running, every shard half halted), ``ragged`` (random running counts,
    one halted lane each), ``idle`` (no lane running), ``all_running``,
    ``full_receivers`` (shard 0 running, every other lane halted: the
    deficit is capped to 0, so nothing moves whatever the spread)."""
    per = lanes // n
    first = lambda *c: (list(c) + [0] * n)[:n]  # noqa: E731
    running, halted = {
        "skew": (first(per, per), 0),
        "capacity": (first(per // 2, per // 2), per // 2),
        "ragged": ([int(rng.integers(0, per)) for _ in range(n)], 1),
        "idle": ([0] * n, per // 2),
        "all_running": ([per] * n, 0),
        "full_receivers": (first(per), [0] + [per] * (n - 1)),
    }[kind]
    return tagged_batch(cfg._replace(lanes=lanes), dev, n, running, halted)


def steal_uses_diff(dev, st, n):
    """The steal kernel in each use on ``st`` against the twins: the
    counts (occupancy_impl), the plan (steal_plan), the moves of the
    twin's plan (steal_apply), and on the card the fused loop's steal
    round from nonzero counters and a steal round of a stopped loop,
    which must write nothing. Returns (plan error, move error, where,
    the twin's plan, its steal decision)."""
    import torch

    from mythril_tpu_torch.laser.cuda import batch, kernels, mesh

    pt = mesh.steal_plan_plain(st, n)
    moved = int(pt.moved)
    go = int(moved > 0 and int(pt.occ.max()) - int(pt.occ.min()) > 1)
    moved_st = mesh.steal_apply_plain(st, pt, n)
    errs10, where = [], []
    errs10.append(tensor_diff(mesh.occupancy_impl(st, n, device=dev), mesh.occupancy_impl_plain(st, n)))
    errs10 += [tensor_diff(a, b) for a, b in zip(mesh.steal_plan(st, n, device=dev), pt)]
    err11, w = batch_diff(mesh.steal_apply(st, pt, n, device=dev), moved_st)
    where.append(w and f"steal_apply {w}")
    if dev.type == "cuda":
        pattern = torch.tensor([-3, -5, 11, 13], dtype=torch.int32, device=dev)
        s = clone_batch(st)
        a = kernels.MeshArgs(s, n)
        a.mctl.copy_(pattern)
        mesh.steal_round(a)
        want_mctl = torch.tensor([go, moved, 11 + go, 13 + go * moved], dtype=torch.int32, device=dev)
        errs10 += [tensor_diff(a.export_.bool(), pt.export), tensor_diff(a.buf_pos, pt.buf_pos),
                   tensor_diff(a.sh, torch.cat([pt.occ, pt.alive_c, pt.filled])), tensor_diff(a.mctl, want_mctl)]
        e, w = batch_diff(s, moved_st if go else st)
        err11 = max(err11, e)
        where.append(w and f"steal_round {w}")
        s = clone_batch(st)
        a = kernels.MeshArgs(s, n, torch.tensor([3, 0, 4, 1], dtype=torch.int32, device=dev))
        for t, v in ((a.export_, 0xA5), (a.buf_pos, -7), (a.sh, -9)):
            t.fill_(v)
        a.mctl.copy_(pattern)
        mesh.steal_round(a)
        errs10 += [int(not (a.export_ == 0xA5).all()), int(not (a.buf_pos == -7).all()),
                   int(not (a.sh == -9).all()), tensor_diff(a.mctl, pattern)]
        e, w = batch_diff(s, st)
        err11 = max(err11, e)
        where.append(w and f"stopped steal_round {w}")
    return max(errs10), err11, [w for w in where if w], pt, go


def compare_steal_kernel(dev, cfg):
    """The steal kernel against the twins in each use (steal_uses_diff)
    at 64, 160, 512 and 1024 lanes over 1, 2, 8 and 64 shards where they
    divide, on each kind of steal_case batch at cfg's widths. Returns the
    plan and move errors and the number of batches compared. Alone:

        python3 -c 'import chip_smoke, torch; from mythril_tpu_torch.laser.cuda import batch;
                    print(chip_smoke.compare_steal_kernel(torch.device("cuda"), batch.DEFAULT_BATCH_CFG))'
    """
    import numpy as np

    rng = np.random.default_rng(20261018)
    err10 = err11 = cases = steals = 0
    for lanes, n in STEAL_SHAPES:
        shape_err = [0, 0]
        for kind in STEAL_KINDS:
            st = steal_case(cfg, dev, lanes, n, kind, rng)
            e10, e11, where, pt, go = steal_uses_diff(dev, st, n)
            cases += 1
            steals += go
            shape_err = [max(shape_err[0], e10), max(shape_err[1], e11)]
            if e10 or e11:
                raise AssertionError(f"the steal kernel differs from the twins at {lanes} lanes over {n} shards "
                                     f"({kind}): plan err {e10}, moves {where}, moved {int(pt.moved)}")
        err10, err11 = max(err10, shape_err[0]), max(err11, shape_err[1])
    emit({"phase": "compare", "kernel": "K10/K11 steal kernel", "shapes": STEAL_SHAPES, "kinds": list(STEAL_KINDS),
          "batches": cases, "steal_rounds_that_moved": steals, "err": [err10, err11], "ok": not (err10 or err11)})
    return err10, err11, cases


def byte_rows(x):
    """A plane's bytes, a row a lane."""
    import torch

    return x.reshape(x.shape[0], -1).view(torch.uint8)


def deal_diff(dev, st, n):
    """K12 (its launch, uncounted) on a copy of ``st`` against the twin:
    the order, every plane, and the kept scratch batch, filled with a
    pattern before, untouched past the rows that move (all of it when
    none moves). Returns (error, where, rows dealt)."""
    import torch

    from mythril_tpu_torch.laser.cuda import batch, kernels, mesh

    L = st.pc.shape[0]
    order_t = mesh.deal_order_plain(st, n)
    want = batch.StateBatch(*(x[order_t] for x in st))
    dealt = int((order_t != torch.arange(L, device=order_t.device)).sum())
    s = clone_batch(st)
    if dev.type != "cuda":
        return batch_diff(mesh.deal_(s, n, device=dev) if n > 1 else want, want) + (dealt,)
    sc = kernels.DealScratch.get(s)
    for x in sc.scratch:
        byte_rows(x).fill_(0xA5)
    order = kernels.launch_mesh_deal(s, n).clone()
    err, where = batch_diff(s, want)
    err = max(err, tensor_diff(order.to(torch.int64), order_t))
    for name, x in zip(batch.StateBatch._fields, sc.scratch):
        if not bool((byte_rows(x)[dealt:] == 0xA5).all()):
            err, where = max(err, 1), f"scratch {name} written past row {dealt}"
    return err, where, dealt


def compare_deal_kernel(dev, cfg):
    """K12 against the twin (deal_diff) on the steal kernel's batches
    (64-1024 lanes over 1-64 shards, six kinds at cfg's widths) and on
    three deals where no lane moves: one shard with its running lanes
    first, a lane a shard with the running lanes first, and two lanes a
    shard with each shard's first lane running. Returns the error."""
    import numpy as np

    rng = np.random.default_rng(20261020)
    err = cases = dealt = 0
    for lanes, n in STEAL_SHAPES:
        for kind in STEAL_KINDS:
            e, where, d = deal_diff(dev, steal_case(cfg, dev, lanes, n, kind, rng), n)
            cases += 1
            dealt += d
            err = max(err, e)
            if e:
                raise AssertionError(f"K12 differs from the twin at {lanes} lanes over {n} shards ({kind}): {where}")
    identity = {"one_shard": (512, 1, [200], 50), "a_lane_a_shard": (64, 64, [1] * 37 + [0] * 27, 0),
                "two_lanes_a_shard": (128, 64, [1] * 64, 0)}
    for label, (lanes, n, running, halted) in identity.items():
        e, where, d = deal_diff(dev, tagged_batch(cfg._replace(lanes=lanes), dev, n, running, halted), n)
        err = max(err, e, d)
        if e or d:
            raise AssertionError(f"K12's identity deal {label} moved {d} rows or differs: {where}")
    emit({"phase": "compare", "kernel": "K12 deal", "shapes": STEAL_SHAPES, "kinds": list(STEAL_KINDS),
          "batches": cases, "rows_dealt": dealt, "identity_deals": list(identity), "err": err, "ok": not err})
    return err


def time_steal_kernel(dev, cfg, n, reps=20):
    """The steal kernel's times at cfg over n shards, on the 96-lane steal
    state (shards 0-1 full of running lanes) and on a gated no-steal state
    (occupancy [per / 2] * (n - 1) + [per / 2 + 1]: moved 1, spread 1):
    through mesh.steal_round and each standalone entry point (``ms``),
    and each launch alone with its arguments built beforehand
    (``launch_ms``; ``device_ms`` queued behind a spinning kernel, the
    device's own time), CUDA events around the call, the inputs rebuilt
    outside the timed region; with each use's bound (bytes). Returns
    (times, plain plan ms, plain moves ms, the steal state's moved lanes
    and row bytes)."""
    import torch

    from mythril_tpu_torch.laser.cuda import batch, kernels, mesh

    on_card = dev.type == "cuda"
    L = cfg.lanes
    per = L // n
    time_ms = functools.partial(events_ms, dev, reps=reps)

    states = {"steal": tagged_batch(cfg, dev, n, ([per, per] + [0] * n)[:n]),
              "no_steal": tagged_batch(cfg, dev, n, [per // 2] * (n - 1) + [per // 2 + 1])}
    rb = sum(x[0].numel() * x.element_size() for x in states["steal"])
    plan_bytes = L * (1 + 4) + L * (1 + 4) + 3 * n * 4 + 4 * 4
    times = {}
    for label, st in states.items():
        pt = mesh.steal_plan_plain(st, n)
        moved = int(pt.moved)
        go = moved > 0 and int(pt.occ.max()) - int(pt.occ.min()) > 1
        move_bytes = moved * (2 * rb + cfg.code_len + 1 + 4 + 4)

        def args(flags_plan=False, s=st, pt=pt):
            a = kernels.MeshArgs(clone_batch(s), n)
            if flags_plan:
                a.export_.copy_(pt.export.to(torch.uint8))
                a.buf_pos.copy_(pt.buf_pos)
                a.sh[n:2 * n].copy_(pt.alive_c)
            return a

        row = {"moved": moved, "steal": bool(go)}
        uses = {
            "steal_round": (lambda a: mesh.steal_round(a), args,
                            lambda a: kernels.launch_mesh_steal(a, kernels.MESH_STEAL_ROUND), args,
                            plan_bytes + (move_bytes if go else 0)),
            "occupancy_impl": (lambda _: mesh.occupancy_impl(st, n, device=dev), None,
                               lambda a: kernels.launch_mesh_steal(a, 0), args, L * (1 + 4) + 2 * n * 4),
            "steal_plan": (lambda _: mesh.steal_plan(st, n, device=dev), None,
                           lambda a: kernels.launch_mesh_steal(a, kernels.MESH_PLAN), args, plan_bytes),
            "steal_apply": (lambda _: mesh.steal_apply(st, pt, n, device=dev), None,
                            lambda a: kernels.launch_mesh_steal(a, kernels.MESH_MOVE),
                            lambda: args(True), L * (1 + 4) + n * 4 + move_bytes),
        }
        for use, (fn, prep, launch, launch_prep, nbytes) in uses.items():
            if not on_card and use == "steal_round":
                continue
            row[use] = {"ms": round(time_ms(fn, prep), 6),
                        "launch_ms": round(time_ms(launch, launch_prep), 6) if on_card else None,
                        "device_ms": round(time_ms(launch, launch_prep, spin=True), 6) if on_card else None,
                        "bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 9)}
        times[label] = row
    ss = states["steal"]
    pt = mesh.steal_plan_plain(ss, n)
    plain10 = time_ms(lambda _: mesh.steal_plan_plain(ss, n), reps=5)
    plain11 = time_ms(lambda _: mesh.steal_apply_plain(ss, pt, n), reps=5)
    return times, plain10, plain11, int(pt.moved), rb


def run_mesh(dev, cfg, smi, rounds=4, steps_per_round=256, n_shards=8, e2e=("bectoken", 3, 120)):
    """Phase 12, the mesh tiers on one card (n_shards lane blocks of one
    batch): the steal kernel (K10/K11) in each use, K12 and the segmented
    K1/K4 against their twins, the fused mesh super-round and one sync
    mesh round against the twins' runs, the skew demos, BECToken through
    SymExecWrapper over the mesh, and the times. Returns the kernels
    line's entries for K10-K12 and the segmented K1/K4 errors."""
    import numpy as np
    import torch

    from mythril_tpu_torch.disassembler.asm import assemble
    from mythril_tpu_torch.laser.cuda import _build, batch, engine, inloop_solve, kernels, megakernel, mesh

    on_card = dev.type == "cuda"
    L, n = cfg.lanes, n_shards
    per = L // n

    def sync():
        if on_card:
            torch.cuda.synchronize()

    zero_counts, read_counts = launch_counters()
    max_err = {"K1": 0, "K4": 0, "K10": 0, "K11": 0, "K12": 0}
    rng = np.random.default_rng(20261019)
    sym = dict(symbolic_calldata=True, symbolic_storage=True, symbolic_caller=True, symbolic_callvalue=True)
    contracts = {
        "becstress": assemble(STRESS_SRC),
        "bectoken": assemble(open(os.path.join(HERE, "bench_contracts", "bectoken.asm")).read()),
    }

    def bank_for(code):
        return batch.make_code_bank([code], cfg.code_len, host_ops=ALWAYS_HOST, freeze_errors=True,
                                    record_storage_events=True, prune_revert=True, device=dev)

    def seeds(n_sym, n_conc):
        specs = [dict(sym) for _ in range(n_sym)]
        for i in range(n_conc):
            cd = int(rng.integers(1, 2**31)).to_bytes(32, "big") + int(rng.integers(0, 6)).to_bytes(32, "big")
            specs.append(dict(calldata=cd + bytes(rng.integers(0, 256, 64, dtype=np.uint8)), caller=0x1000 + i))
        return specs

    # ---- 12a. the steal kernel (K10/K11) and K12 alone; K1 and K4 with a shard count
    err10, err11, _cases = compare_steal_kernel(dev, cfg)
    max_err["K10"], max_err["K11"] = max(max_err["K10"], err10), max(max_err["K11"], err11)
    max_err["K12"] = max(max_err["K12"], compare_deal_kernel(dev, cfg))
    cases = {kind: steal_case(cfg, dev, L, n, kind, rng) for kind in ("skew", "capacity", "ragged")}
    for name, st in cases.items():
        err10, err11, where11, pt, _go = steal_uses_diff(dev, st, n)
        dk, dt = mesh.rebalance(st, n, device=dev), mesh.rebalance_plain(st, n)
        err12, where12 = batch_diff(dk, dt)
        max_err["K10"] = max(max_err["K10"], err10)
        max_err["K11"] = max(max_err["K11"], err11)
        max_err["K12"] = max(max_err["K12"], err12)
        emit({"phase": "compare", "kernel": "K10/K11/K12", "case": name, "lanes": L, "shards": n,
              "occ": pt.occ.tolist(), "moved": int(pt.moved), "filled": pt.filled.tolist(),
              "err": [err10, err11, err12], "ok": not (err10 or err11 or err12)})
        if err10 or err11 or err12:
            raise AssertionError(f"mesh kernels differ from their twins on {name}: plan {err10}, "
                                 f"steal {where11}, deal {where12}")
    steal_state = cases["skew"]

    cb_t = bank_for(contracts["bectoken"])
    st_k = st_t = batch.build_batch(cfg, seeds(per // 4, per // 4), device=dev)
    for i in range(64):  # every seed in shard 0: its forks fill it, then trap
        st_k = engine.step(cb_t, None, st_k, device=dev, n_shards=n)
        st_t = engine.step_plain(cb_t, st_t, n)
        err, where = batch_diff(st_k, st_t)
        max_err["K1"] = max(max_err["K1"], err)
        if err:
            raise AssertionError(f"K1 (n_shards={n}) differs from the twin at step {i}: {where}")
    traps = int(((st_t.status == batch.TRAP) & (st_t.trap_op == 0x57)).sum())
    emit({"phase": "compare", "kernel": "K1 sharded", "contract": "bectoken", "steps": 64, "shards": n,
          "alive": int(st_t.alive.sum()), "jumpi_traps": traps, "ok": True})
    unsat = (torch.as_tensor(rng.random(L) < 0.1, device=dev) & st_t.alive)
    acc_t = torch.zeros(4, dtype=torch.int32, device=dev)
    pv_t = torch.zeros(cb_t.code.shape, dtype=torch.bool, device=dev)
    out_t = megakernel.round_epilogue_plain(cb_t, st_t, unsat, acc_t, pv_t, n)
    st4 = clone_batch(st_t)
    acc_k, pv_k = torch.zeros_like(acc_t), torch.zeros_like(pv_t)
    ctl = torch.tensor([0, 1, 0, 0], dtype=torch.int32, device=dev)
    if on_card:
        megakernel.round_epilogue(cb_t, st4, unsat, acc_k, pv_k, ctl, 16, batch.StateBatch(
            *(torch.empty_like(x) for x in st4)), n)
    else:
        st4 = megakernel.round_epilogue_plain(cb_t, st4, unsat, acc_k, pv_k, n)
    err, where = batch_diff(st4, out_t)
    err = max(err, tensor_diff(acc_k, acc_t), tensor_diff(pv_k, pv_t))
    max_err["K4"] = max(max_err["K4"], err)
    emit({"phase": "compare", "kernel": "K4 sharded", "shards": n, "acc": acc_t.tolist(), "ok": not err})
    if err:
        raise AssertionError(f"K4 (n_shards={n}) differs from the twin: {where}")

    # ---- 12b. the fused mesh super-round against the twin's -----------------
    m = mesh.make_mesh(n, device=dev, cards=[dev])
    pool0 = inloop_solve.empty_pool(dev)
    n_seeds = min(16, per)
    results = {}
    for name in ("becstress", "bectoken"):
        cb = bank_for(contracts[name])
        st = batch.build_batch(cfg, [dict(sym) for _ in range(n_seeds // 2)] + seeds(0, n_seeds // 2),
                               device=dev)  # all in shard 0
        with_stats = name == "becstress"
        sync()
        zero_counts()
        t0 = time.perf_counter()
        if on_card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = megakernel.run_fused_mesh(m, cb, None, st, max_rounds=rounds, steps_per_round=steps_per_round,
                                            with_stats=with_stats, with_solve=True, pool=pool0)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        t_enq = time.perf_counter()
        stats = megakernel.decode_mesh_info(out.info, n)
        wall = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        ot = megakernel.run_fused_mesh_plain(cb, st, n, rounds, steps_per_round, True, pool0, with_stats)
        err, where = batch_diff(out.st, ot.st)
        ok = (not err and torch.equal(out.info, ot.info) and torch.equal(out.pruned_visited, ot.pruned_visited)
              and torch.equal(out.hist, ot.hist))
        max_err["K1"] = max(max_err["K1"], err)
        results[name] = (cb, st, stats, counts, out, dict(max_rounds=rounds, steps_per_round=steps_per_round,
                                                          with_stats=with_stats, with_solve=True, pool=pool0))
        emit({"phase": "mesh_vs_twin", "contract": name, "shards": n, "with_stats": with_stats,
              "info": stats._asdict(), "retired": int(out.st.steps.sum()) + stats.pruned_steps,
              "wall_ms": round(wall, 3), "enqueue_ms": round((t_enq - t0) * 1e3, 3), "launches": counts,
              "ok": bool(ok)})
        if not ok:
            raise AssertionError(f"{name}: the fused mesh super-round differs from the twin: {where} "
                                 f"info {out.info.tolist()} vs {ot.info.tolist()}")
        if on_card and min(counts[k] for k in ("K1", "K3", "K4", "K10", "K11", "mesh_steal")) <= 0:
            raise AssertionError(f"{name}: a kernel of the fused mesh loop never launched: {counts}")
        # the round's steal is one launch of the steal kernel (plan, decision, moves), not K10 then K11
        if on_card and not counts["mesh_steal"] == counts["K10"] == counts["K11"] == rounds:
            raise AssertionError(f"{name}: the fused mesh loop did not make one steal launch a round: {counts}")
        if on_card and (counts["K1"] != rounds or counts["K2"] or counts["K8"]
                        or counts["K1_steps"] != rounds * steps_per_round
                        or counts["K1_stats"] != (rounds if with_stats else 0)):
            raise AssertionError(f"{name}: the fused mesh loop did not run one K1 launch per round: {counts}")
    fused_mesh_counts = {k: sum(r[3][k] for r in results.values()) for k in read_counts()}

    # ---- 12c. one sync mesh round (the deal) against the twin's --------------
    cb_r, st_r = results["bectoken"][0], results["bectoken"][1]
    sync()
    c_launches0 = kernels.mesh_kernel_launches() if on_card else None
    zero_counts()
    out_k, occ_k = mesh.sharded_round(cb_r, None, st_r, steps_per_round=steps_per_round, do_rebalance=True,
                                      n_shards=n, device=dev)
    sync()
    sync_counts = read_counts()
    if on_card:  # the kernel launches mesh.cu made, counted in C where each is launched
        c_launches1 = kernels.mesh_kernel_launches()
        sync_counts["mesh_cu_launches"] = {k: c_launches1[k] - c_launches0[k] for k in c_launches1}
    out_t, occ_t = mesh.round_impl_plain(cb_r, st_r, steps_per_round, True, n)
    err, where = batch_diff(out_k, out_t)
    err = max(err, tensor_diff(occ_k, occ_t))
    max_err["K12"] = max(max_err["K12"], err)
    emit({"phase": "mesh_sync_vs_twin", "contract": "bectoken", "steps": steps_per_round, "occ": occ_t.tolist(),
          "launches": sync_counts, "ok": not err})
    if err:
        raise AssertionError(f"sharded_round differs from the twin: {where}")
    # the round's slice is one K1 launch (no K9), then the deal and the
    # occupancy: one steal-kernel launch that counts and moves nothing
    # (the deal: one K12 call, one kernel launch of mesh.cu's deal)
    if on_card and (min(sync_counts[k] for k in ("K1", "K10", "K12")) <= 0 or sync_counts["K1"] != 1
                    or sync_counts["K9"] or sync_counts["mesh_steal"] != 1 or sync_counts["K11"]
                    or sync_counts["K12"] != 1
                    or sync_counts["mesh_cu_launches"] != {"steal": 1, "deal": 1, "cards": 0}):
        raise AssertionError(f"the sync mesh round did not launch one K1, one counting steal kernel and one "
                             f"K12 kernel: {sync_counts}")

    # ---- 12d. the skew demos ------------------------------------------------
    loop_code = assemble(LOOP_SRC)
    demos = {}
    for lanes_, spinning in ((64, 16), (L, L // 4)):
        cfg_d = cfg._replace(lanes=lanes_)
        cb_d = batch.make_code_bank([loop_code], cfg.code_len, device=dev)
        st_d = batch.build_batch(cfg_d, [dict(calldata=b"", gas=10_000_000)] * spinning, device=dev)
        before = read_counts()
        out_d = megakernel.run_fused_mesh(mesh.make_mesh(n, device=dev, cards=[dev]), cb_d, None, st_d, max_rounds=4,
                                          steps_per_round=64, with_solve=True, pool=pool0)
        stats = megakernel.decode_mesh_info(out_d.info, n)
        steps = int(out_d.st.steps.sum())
        ot = megakernel.run_fused_mesh_plain(cb_d, st_d, n, 4, 64, True, pool0)
        err, where = batch_diff(out_d.st, ot.st)
        err = max(err, tensor_diff(out_d.info, ot.info))
        max_err["K11"] = max(max_err["K11"], err)
        if err:
            raise AssertionError(f"skew demo at {lanes_} lanes differs from the twin: {where}")
        want_occ = [spinning // n] * n
        want_moved = spinning - 2 * (spinning // n)
        demos[lanes_] = {"spinning": spinning, "steal_events": stats.steal_events,
                         "steal_lanes": stats.steal_lanes, "occupancy": list(stats.occupancy),
                         "spread": max(stats.occupancy) - min(stats.occupancy), "steps": steps,
                         "steps_expected": spinning * 4 * 64,
                         "steal_launches": read_counts()["mesh_steal"] - before["mesh_steal"]}
        emit({"phase": "mesh_skew_demo", "lanes": lanes_, "shards": n, **demos[lanes_]})
        if (stats.steal_events != 1 or stats.steal_lanes != want_moved or list(stats.occupancy) != want_occ
                or steps != spinning * 4 * 64):
            raise AssertionError(f"skew demo at {lanes_} lanes: {demos[lanes_]}, expected 1 steal of "
                                 f"{want_moved} lanes, occupancy {want_occ}")

    # ---- 12e. the whole analysis over the mesh (8 virtual cards, one shard a card)
    e2e_counts = run_mesh_e2e(dev, cfg, smi, n, e2e)

    # ---- 12f. times ------------------------------------------------------------
    time_ms = functools.partial(events_ms, dev)

    ss = steal_state
    steal_times, plain10, plain11, moved, rb = time_steal_kernel(dev, cfg, n)
    mesh_log = os.path.join(_build.BUILD_DIR, "mesh.log")
    ptxas = [ln.strip() for ln in open(mesh_log) if any(k in ln for k in ("entry function", "registers", "spill"))
             ] if os.path.exists(mesh_log) else []
    emit({"phase": "timing_steal_kernel", "gpu": smi, "lanes": L, "shards": n, "row_bytes": rb,
          "times": steal_times, "plain_ms": {"steal_plan": plain10, "steal_apply": plain11},
          "resources": kernels.mesh_steal_info(dev) if on_card else None, "ptxas_mesh_cu": ptxas})
    # K12 on the steal state: its launch alone on a fresh copy (events
    # around it; ms_device behind a spinning kernel), through rebalance
    # (a clone, then the deal in place) and within sharded_round (256 K1
    # steps on BECToken, the deal, the occupancy), beside the round
    # without the deal
    if on_card:
        ms12 = time_ms(lambda a: kernels.launch_mesh_deal(a, n), lambda: clone_batch(ss))
        ms12_device = time_ms(lambda a: kernels.launch_mesh_deal(a, n), lambda: clone_batch(ss), spin=True)
    else:
        ms12 = ms12_device = time_ms(lambda _: mesh.rebalance(ss, n, device=dev))
    rebalance_ms = time_ms(lambda _: mesh.rebalance(ss, n, device=dev))
    round_ms = {f"do_rebalance_{d}": round(time_ms(lambda _, d=d: mesh.sharded_round(
        cb_r, None, st_r, steps_per_round=steps_per_round, do_rebalance=d, n_shards=n, device=dev), reps=5), 6)
        for d in (True, False)}
    plain12 = time_ms(lambda _: mesh.rebalance_plain(ss, n), reps=5)
    order = mesh.deal_order_plain(ss, n)
    dealt = int((order != torch.arange(L, device=dev)).sum())
    bytes12 = 9 * L + dealt * 2 * rb  # the plan's 5 bytes a lane and order's 4; each dealt row read and written once
    emit({"phase": "timing_deal", "gpu": smi, "lanes": L, "shards": n, "rows_dealt": dealt, "row_bytes": rb,
          "ms": round(ms12, 6), "ms_device": round(ms12_device, 6), "rebalance_ms": round(rebalance_ms, 6),
          "sharded_round_ms": round_ms, "plain_ms": round(plain12, 6),
          "bound_ms": round(bytes12 / HBM_BYTES_PER_S * 1e3, 9),
          "resources": kernels.mesh_deal_info(dev) if on_card else None})

    cb_w, st_w = results["becstress"][0], results["becstress"][1]

    def wall_of(fn):
        sync()
        e0 = torch.cuda.Event(enable_timing=True) if on_card else None
        e1 = torch.cuda.Event(enable_timing=True) if on_card else None
        t0 = time.perf_counter()
        if on_card:
            e0.record()
        fn()
        if on_card:
            e1.record()
            torch.cuda.synchronize()
            return round(e0.elapsed_time(e1), 3)
        return round((time.perf_counter() - t0) * 1e3, 3)

    super_rounds = {}
    for label, fn in (
        ("run_fused", lambda: megakernel.decode_info(megakernel.run_fused(
            cb_w, None, st_w, max_rounds=rounds, steps_per_round=steps_per_round, with_solve=True, pool=pool0,
            device=dev).info)),
        ("run_fused_mesh", lambda: megakernel.decode_mesh_info(megakernel.run_fused_mesh(
            m, cb_w, None, st_w, max_rounds=rounds, steps_per_round=steps_per_round, with_solve=True,
            pool=pool0).info, n)),
    ):
        super_rounds[label] = [wall_of(fn), wall_of(fn)]
    emit({"phase": "timing_mesh", "gpu": smi, "shards": n, "steal_state": {"moved": moved, "dealt": dealt},
          "super_round_ms_becstress": super_rounds, "K12_ms": ms12})

    def entry(kid, name, source, replaces, launches, ms, plain, bound, by_path, launch_ms=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": by_path, "max_abs_err": max_err[kid],
                "ms": round(ms, 6), "launch_ms": launch_ms, "plain_ms": round(plain, 6),
                "bound_ms": round(bound, 9), "bound_by": "bytes", "library_ms": None}

    # K10 and K11 are one kernel: K10's row is its plan (steal_plan on the
    # steal state), K11's its moves as the fused loop launches them (a
    # steal round that moves the steal state's lanes); each row's
    # launches count the launches that did its function. Their main path
    # is the one-card mesh's fused loop (12b): the analysis over the mesh
    # (12e) runs on 8 virtual cards, whose steal is the cross-card
    # exchange (run_mesh_cards' rows).
    by10 = {"e2e_mesh": e2e_counts["K10"], "fused_mesh": fused_mesh_counts["K10"], "sync_mesh": sync_counts["K10"]}
    by11 = {"e2e_mesh": e2e_counts["K11"], "fused_mesh": fused_mesh_counts["K11"],
            "skew_demos": sum(d["steal_launches"] for d in demos.values())}
    by12 = {"sync_mesh": sync_counts["K12"], "e2e_mesh": e2e_counts["K12"]}
    kernel_launches = {"e2e_mesh": e2e_counts["mesh_steal"], "fused_mesh": fused_mesh_counts["mesh_steal"],
                       "sync_mesh": sync_counts["mesh_steal"]}
    round_ms = {label: row.get("steal_round", {}).get("ms") for label, row in steal_times.items()}
    sp, sr = steal_times["steal"]["steal_plan"], steal_times["steal"].get("steal_round", {})
    return [
        dict(entry("K10", "K10 mesh_steal (counts, plan)", "mythril_tpu_torch/csrc/mesh.cu",
                   "mythril_tpu/laser/tpu/mesh.py:127", fused_mesh_counts["K10"], sp["ms"], plain10, sp["bound_ms"],
                   by10, sp["launch_ms"]), steal_round_ms=round_ms, steal_kernel_launches=kernel_launches),
        dict(entry("K11", "K11 mesh_steal (moves)", "mythril_tpu_torch/csrc/mesh.cu",
                   "mythril_tpu/laser/tpu/mesh.py:178", fused_mesh_counts["K11"], sr.get("ms", 0.0), plain11,
                   sr.get("bound_ms", 0.0), by11, sr.get("launch_ms")),
             steal_round_ms=round_ms, steal_kernel_launches=kernel_launches, moved=moved),
        dict(entry("K12", "K12 mesh_deal", "mythril_tpu_torch/csrc/mesh.cu",
                   "mythril_tpu/laser/tpu/mesh.py:83", sync_counts["K12"], ms12, plain12,
                   bytes12 / HBM_BYTES_PER_S * 1e3, by12),
             ms_device=round(ms12_device, 6), rebalance_ms=round(rebalance_ms, 6), rows_dealt=dealt),
    ], {"K1": max_err["K1"], "K4": max_err["K4"]}, (e2e_counts, {k: (r[0], r[1], r[5], r[4]) for k, r in results.items()})

def card_row_bytes(st):
    return sum(x[0].numel() * x.element_size() for x in st)


def exchange_case_diff(dev, st, n, cards, devices=None):
    """The cross-card exchange's three modes (mesh.CardExchange: each a
    launch on every card) on ``st`` split over ``cards`` cards (virtual
    cards of ``dev``, or ``devices``) against the twins on the same
    lanes: the gathered counts in every card's buffer (XC_COUNT), each
    card's batch after its plan and in-place moves, its steal word, held
    counts and restaged continue bit (XC_PLAN), and the joined batch
    after the pulls, which must be the one-batch layout's steal
    (steal_plan_plain + steal_apply_plain on the joined batch, gated as
    the fused loop gates it). Returns ({mode: error}, where, the twin's
    plan, go, the lanes moved across cards)."""
    import torch

    from mythril_tpu_torch.laser.cuda import mesh

    m = mesh.make_mesh(n, device=dev, cards=devices or [dev] * cards)
    parts = [clone_batch(p) for p in mesh.shard_batch(st, m)]
    orig = [clone_batch(p) for p in parts]
    plan = mesh.steal_plan_plain(st, n)
    go = int(plan.moved) > 0 and int(plan.occ.max()) - int(plan.occ.min()) > 1
    want = mesh.steal_apply_plain(st, plan, n) if go else st
    ctls = [torch.tensor([4, 1, 5, 0], dtype=torch.int32, device=p.pc.device) for p in parts]
    ex = mesh.CardExchange(parts, n, ctls, 9)
    err = {"XC_COUNT": 0, "XC_PLAN": 0, "XC_PULL": 0}
    where = []
    ex.count()
    flat = torch.stack([plan.occ, plan.alive_c], 1).flatten().to(torch.int32)
    for g in ex.gaths:
        err["XC_COUNT"] = max(err["XC_COUNT"], tensor_diff(g.to(flat.device), flat))
    ex.plan()
    counts = flat.view(n, 2)
    for k, (p, o) in enumerate(zip(parts, orig)):
        tp, _send, tgo, tmoved = mesh.card_plan_plain(o, counts.to(o.pc.device), k, cards)
        e, w = batch_diff(p, tp)
        word = torch.tensor([int(tgo), tmoved, int(tgo), tmoved if tgo else 0], dtype=torch.int32)
        e = max(e, tensor_diff(ex.mctls[k].cpu(), word), tensor_diff(ex.args[k].held.cpu(), flat.cpu()),
                tensor_diff(ctls[k].cpu(), torch.tensor([4, 1, 5, int(int(plan.occ.sum()) > 0)], dtype=torch.int32)))
        err["XC_PLAN"] = max(err["XC_PLAN"], e)
        if w:
            where.append(f"card {k} after XC_PLAN: {w}")
    ex.pull()
    e, w = batch_diff(mesh.gather_batch(mesh.PerCard(parts), m), want)
    err["XC_PULL"] = e
    if w:
        where.append(f"after XC_PULL: {w}")
    nl = n // cards
    L = st.pc.shape[0]
    per = L // n
    dest_card = torch.div(plan.buf_pos.long(), per * nl, rounding_mode="floor")
    donor_card = torch.div(torch.arange(L, device=plan.buf_pos.device), per * nl, rounding_mode="floor")
    crossed = int((plan.export & (dest_card != donor_card)).sum()) if go else 0
    return err, where, plan, go, crossed


def run_mesh_cards(dev, cfg, smi, e2e_counts, one_card, rounds=4, steps_per_round=256, n_shards=8):
    """Phase 12g, the fused mesh tier over several cards, each card
    holding n / cards contiguous shards as a batch of its own, the steal
    the cross-card exchange (XC_COUNT, XC_PLAN, XC_PULL; mesh.cu's
    mesh_cards_kernel): the exchange's modes against the twins on the
    steal kernel's compare batches over 2 and 8 virtual cards of the
    card; run_fused_mesh over 2 and 8 virtual cards against the one-card
    layout (every plane, info, pruned_visited, hist) on 12b's inputs,
    against 12b's own outputs (``one_card``: contract -> (code bank,
    batch, run_fused_mesh's arguments, output), each held against the
    twin there), under torch's sync debug mode, with
    the launches a round; the same over the host's real cards where it
    has two or more; the skew demo over 2 cards; the times of the
    super-round and of each mode. Returns the kernels line's entries for
    the exchange's modes (launches: the analysis over 8 virtual cards,
    12e) and the K1/K4 errors."""
    import numpy as np
    import torch

    from mythril_tpu_torch.disassembler.asm import assemble
    from mythril_tpu_torch.laser.cuda import batch, inloop_solve, kernels, megakernel, mesh

    on_card = dev.type == "cuda"
    L, n = cfg.lanes, n_shards
    zero_counts, read_counts = launch_counters()
    max_err = {"XC_COUNT": 0, "XC_PLAN": 0, "XC_PULL": 0, "K1": 0, "K4": 0}
    rng = np.random.default_rng(20261020)
    n_real = torch.cuda.device_count() if on_card else 0
    real = min(mesh.n_devices(dev) if on_card else 0, kernels.MESH_MAX_CARDS)  # the cards that reach each other
    while real >= 2 and n % real:
        real -= 1
    layouts = [("virtual", k, [dev] * k) for k in (2, 8)]
    if real >= 2:
        layouts.append(("real", real, [torch.device("cuda", i) for i in range(real)]))

    def sync():
        if on_card:
            for d in range(max(1, n_real)):
                torch.cuda.synchronize(d)

    # ---- 12g-1. the exchange's modes against the twins --------------------
    for kind in ("skew", "capacity", "ragged", "idle", "full_receivers"):
        for lanes, nn in ((L, n), (L, 64), (64, 8)):
            st = steal_case(cfg, dev, lanes, nn, kind, rng)
            for label, k, devs in layouts:
                if nn % k:
                    continue
                err, where, plan, go, crossed = exchange_case_diff(dev, st, nn, k, devs)
                for mode, e in err.items():
                    max_err[mode] = max(max_err[mode], e)
                if any(err.values()):
                    raise AssertionError(f"the exchange over {k} {label} cards differs from the twins on {kind} "
                                         f"({lanes} lanes, {nn} shards): {err} {where}")
    emit({"phase": "compare", "kernel": "XC_COUNT/XC_PLAN/XC_PULL", "cases": "steal_case kinds x (512 lanes, 8 "
          "and 64 shards; 64 lanes, 8 shards)", "layouts": [(lb, k) for lb, k, _ in layouts], "err": max_err,
          "ok": True})

    # ---- 12g-2. the super-round over cards against the one-card layout ------
    # on 12b's inputs, against 12b's outputs: 12b held those against the twin
    pool0 = inloop_solve.empty_pool(dev)
    phase_counts = {}
    supers = {}
    for name, (cb, st, kw, one) in one_card.items():
        with_stats = kw["with_stats"]
        if (kw["max_rounds"], kw["steps_per_round"]) != (rounds, steps_per_round):
            raise AssertionError(f"12b ran {name} at {kw}, not {rounds} x {steps_per_round} steps")
        one_stats = megakernel.decode_mesh_info(one.info, n)
        for label, k, devs in layouts:
            m = mesh.make_mesh(n, device=dev, cards=devs)
            megakernel.run_fused_mesh(m, cb, None, st, **kw)  # first use: each card's kept scratch is made
            sync()
            zero_counts()
            t0 = time.perf_counter()
            if on_card:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = megakernel.run_fused_mesh(m, cb, None, st, **kw)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
            t_enq = time.perf_counter()
            stats = megakernel.decode_mesh_info(out.info, n)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            for key, v in counts.items():
                phase_counts[key] = phase_counts.get(key, 0) + v
            err, where = batch_diff(mesh.gather_batch(out.st, m), one.st)
            ok = (not err and torch.equal(out.info, one.info) and torch.equal(out.pruned_visited, one.pruned_visited)
                  and torch.equal(out.hist, one.hist))
            max_err["K1"] = max(max_err["K1"], err)
            want = {"K1": rounds * k, "K4": 2 * rounds * k, "XC_COUNT": (rounds + 1) * k, "XC_PLAN": rounds * k,
                    "XC_PULL": rounds * k, "mesh_steal": 0, "K1_steps": rounds * k * steps_per_round,
                    "K1_stats": rounds * k if with_stats else 0}
            launches_ok = not on_card or all(counts[key] == v for key, v in want.items())
            emit({"phase": "mesh_cards_vs_one_card", "contract": name, "cards": k, "layout": label, "shards": n,
                  "with_stats": with_stats, "info": stats._asdict(), "one_card_info": one_stats._asdict(),
                  "wall_ms": round(wall, 3), "enqueue_ms": round((t_enq - t0) * 1e3, 3), "launches": counts,
                  "launches_expected": want, "ok": bool(ok and launches_ok)})
            if not ok:
                raise AssertionError(f"{name} over {k} {label} cards differs from the one-card layout: {where} "
                                     f"info {out.info.tolist()} vs {one.info.tolist()}")
            if not launches_ok:
                raise AssertionError(f"{name} over {k} {label} cards: launches {counts}, expected {want}")
        supers[name] = (cb, st, kw)

    # ---- 12g-3. the skew demo over 2 cards ------------------------------------
    cb_d = batch.make_code_bank([assemble(LOOP_SRC)], cfg.code_len, device=dev)
    spinning = L // 4
    st_d = batch.build_batch(cfg, [dict(calldata=b"", gas=10_000_000)] * spinning, device=dev)
    kw_d = dict(max_rounds=4, steps_per_round=64, with_solve=True, pool=pool0)
    one = megakernel.run_fused_mesh(mesh.make_mesh(n, device=dev, cards=[dev]), cb_d, None, st_d, **kw_d)
    m2 = mesh.make_mesh(n, device=dev, cards=[dev] * 2)
    two = megakernel.run_fused_mesh(m2, cb_d, None, st_d, **kw_d)
    s1, s2 = megakernel.decode_mesh_info(one.info, n), megakernel.decode_mesh_info(two.info, n)
    err, where = batch_diff(mesh.gather_batch(two.st, m2), one.st)
    max_err["XC_PULL"] = max(max_err["XC_PULL"], err)
    demo = {"spinning": spinning, "steal_events": s2.steal_events, "steal_lanes": s2.steal_lanes,
            "occupancy": list(s2.occupancy), "one_card": [s1.steal_events, s1.steal_lanes, list(s1.occupancy)],
            "steps": int(mesh.gather_batch(two.st, m2).steps.sum()), "steps_expected": spinning * 4 * 64}
    emit({"phase": "mesh_cards_skew_demo", "lanes": L, "shards": n, "cards": 2, **demo, "ok": not err})
    if err or (s2.steal_events, s2.steal_lanes, s2.occupancy) != (s1.steal_events, s1.steal_lanes, s1.occupancy) \
            or s2.steal_events != 1 or demo["steps"] != demo["steps_expected"]:
        raise AssertionError(f"the skew demo over 2 cards differs from the one-card layout: {where} {demo}")

    # ---- 12g-4. times --------------------------------------------------------
    ss = steal_case(cfg, dev, L, n, "skew", rng)
    rb = card_row_bytes(ss)
    times = {}
    for label, k, devs in layouts:
        m = mesh.make_mesh(n, device=dev, cards=devs)

        def prep(upto, m=m):
            parts = [clone_batch(p) for p in mesh.shard_batch(ss, m)]
            ctls = [torch.tensor([4, 1, 5, 0], dtype=torch.int32, device=p.pc.device) for p in parts]
            ex = mesh.CardExchange(parts, n, ctls, 9)
            for step in (ex.count, ex.plan)[:upto]:
                step()
            return ex

        row = {mode: round(events_ms(dev, fn, lambda u=u: prep(u)), 6) for mode, fn, u in (
            ("XC_COUNT", lambda ex: ex.count(), 0), ("XC_PLAN", lambda ex: ex.plan(), 1),
            ("XC_PULL", lambda ex: ex.pull(), 2), ("exchange", lambda ex: ex.steal_round(), 0))}
        row["plain_ms"] = round(events_ms(dev, lambda parts: mesh.exchange_plain(parts, n), lambda m=m: mesh.PerCard(
            clone_batch(p) for p in mesh.shard_batch(ss, m)), reps=5), 6)
        cb_w, st_w, kw_w = supers["becstress"]
        row["super_round_ms_becstress"] = round(events_ms(dev, lambda _: megakernel.run_fused_mesh(
            m, cb_w, None, st_w, **kw_w), reps=3), 6)
        _e, _w, plan, go, crossed = exchange_case_diff(dev, ss, n, k, devs)
        moved = int(plan.moved)
        nbytes = {"XC_COUNT": 5 * L + 8 * n * k,
                  "XC_PLAN": 5 * L + 16 * n * k + 2 * moved * rb,
                  "XC_PULL": 8 * n * k + 2 * crossed * rb}
        row["bound_ms"] = {mode: round(b / HBM_BYTES_PER_S * 1e3, 9) for mode, b in nbytes.items()}
        row["moved"], row["crossed"], row["row_bytes"] = moved, crossed, rb
        times[f"{label}_{k}"] = row
    one_card_ms = round(events_ms(dev, lambda _: megakernel.run_fused_mesh(
        mesh.make_mesh(n, device=dev, cards=[dev]), supers["becstress"][0], None, supers["becstress"][1],
        **supers["becstress"][2]), reps=3), 6)
    emit({"phase": "timing_mesh_cards", "gpu": smi, "lanes": L, "shards": n, "steal_state": "skew",
          "times": times, "super_round_ms_becstress_one_card": one_card_ms,
          "real_cards": real if real >= 2 else "not available (device_count %d, %d reaching each other)" % (
              n_real, mesh.n_devices(dev) if on_card else 0),
          "resources": kernels.mesh_cards_info(dev) if on_card else None})

    t2 = times["virtual_2"]
    entries = []
    for mode, name, replaces in (
            ("XC_COUNT", "XC_COUNT mesh_cards (counts to every card)", "mythril_tpu/laser/tpu/mesh.py:142"),
            ("XC_PLAN", "XC_PLAN mesh_cards (plan, moves in place, pack)", "mythril_tpu/laser/tpu/mesh.py:127"),
            ("XC_PULL", "XC_PULL mesh_cards (imports from the send batches)", "mythril_tpu/laser/tpu/mesh.py:178")):
        entries.append({"name": name, "route": "cuda", "source": "mythril_tpu_torch/csrc/mesh.cu",
                        "replaces": replaces, "launches": e2e_counts[mode],
                        "launches_by_path": {"e2e_mesh": e2e_counts[mode], "mesh_cards": phase_counts.get(mode, 0)},
                        "max_abs_err": max_err[mode], "ms": t2[mode], "plain_ms": t2["plain_ms"],
                        "bound_ms": t2["bound_ms"][mode], "bound_by": "bytes", "library_ms": None,
                        "ms_by_layout": {lb: row[mode] for lb, row in times.items()},
                        "bound_ms_by_layout": {lb: row["bound_ms"][mode] for lb, row in times.items()},
                        "timed_on": f"the skew state ({L} lanes, {n} shards) over 2 virtual cards"})
    return entries, {"K1": max_err["K1"], "K4": max_err["K4"]}


def launch_counters():
    """(zero_counts, read_counts) over the launch counts of K1-K12 (and of
    K1's steps and stats instance; K10 and K11 count the steal kernel's
    launches that counted or planned, and that moved or decided whether
    to, ``mesh_steal`` all its launches; XC_COUNT, XC_PLAN and XC_PULL the
    cross-card exchange's, by mode)."""
    from mythril_tpu_torch.laser.cuda import engine, inloop_solve, keccak, megakernel, mesh, solver, transfer

    counters = {"K1": (engine, "launches"), "K1_steps": (engine, "steps_run"), "K1_stats": (engine, "stats_launches"),
                "K2": (keccak, "launches"), "K3": (inloop_solve, "launches"), "K4": (megakernel, "launches"),
                "K5": (solver, "launches"), "K6": (transfer, "unpack_launches"), "K7": (transfer, "pack_launches"),
                "K8": (engine, "hist_launches"), "K9": (engine, "slice_launches"),
                "K10": (mesh, "plan_launches"), "K11": (mesh, "steal_launches"), "K12": (mesh, "deal_launches"),
                "mesh_steal": (mesh, "launches"), "XC_COUNT": (mesh, "xc_count_launches"),
                "XC_PLAN": (mesh, "xc_plan_launches"), "XC_PULL": (mesh, "xc_pull_launches")}

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    return zero_counts, read_counts


def run_mesh_e2e(dev, cfg, smi, n=8, e2e=("bectoken", 3, 120)):
    """Phase 12e: one whole analysis through SymExecWrapper over a mesh of
    n lane shards on n virtual cards of the card, one shard a card, the
    layout production takes on a host of n cards (MYTHRIL_TPU_MESH=on,
    mesh.n_devices patched to n, mesh.card_devices to n copies of the
    card): each card holds its own lanes and the fused loop's steal is
    the cross-card exchange. The kernels are built and the strategy warms its
    config itself, inside the run, as in the e2e phases. Beside the issue
    set it prints when the device engaged (the first upload of a round,
    seconds after the analysis started), how long the strategy's warmup
    took, and what the solver cache answered. Returns the launch counts.
    Run alone in a fresh process it is the cold analysis:

        python3 -c 'import chip_smoke as c, torch; from mythril_tpu_torch.laser.cuda import _build, batch;
                    _build.build_all(); c.run_mesh_e2e(torch.device("cuda"), batch.DEFAULT_BATCH_CFG, c.smi_line())'
    """
    import threading

    import torch

    from mythril_tpu_torch.analysis.security import fire_lasers
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
    from mythril_tpu_torch.disassembler.asm import assemble
    from mythril_tpu_torch.ethereum.evmcontract import EVMContract
    from mythril_tpu_torch.laser.cuda import backend, mesh, solver_cache, transfer
    from mythril_tpu_torch.obs import catalog as cat
    from mythril_tpu_torch.robustness import retry

    on_card = dev.type == "cuda"
    zero_counts, read_counts = launch_counters()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    name, tx, budget = e2e
    runtime = assemble(STRESS_SRC) if name == "becstress" else assemble(
        open(os.path.join(HERE, "bench_contracts", "bectoken.asm")).read())
    nb = len(runtime)
    creation = assemble(
        f"PUSH2 {nb}\nPUSH2 :code\nPUSH1 0x00\nCODECOPY\nPUSH2 {nb}\nPUSH1 0x00\nRETURN\ncode:"
    ).hex() + runtime.hex()
    t1 = [0.0]
    uploads = []  # seconds after t1 of each round's upload (not the warmup's)
    warm_s = [0.0]
    warm_threads = set()
    orig_up, orig_warm = transfer.batch_to_device, backend._do_warmup

    def up_rec(np_batch, cfg_, device="cuda"):
        if threading.get_ident() not in warm_threads:
            uploads.append(time.time() - t1[0])
        return orig_up(np_batch, cfg_, device=device)

    def warm_rec(key, event):
        t = time.perf_counter()
        warm_threads.add(threading.get_ident())
        try:
            return orig_warm(key, event)
        finally:
            warm_threads.discard(threading.get_ident())
            warm_s[0] += time.perf_counter() - t

    mesh_env = os.environ.get("MYTHRIL_TPU_MESH")
    n_devices, card_devices = mesh.n_devices, mesh.card_devices
    os.environ["MYTHRIL_TPU_MESH"] = "on"
    mesh.n_devices = lambda device="cuda": n  # n lane shards ...
    mesh.card_devices = lambda n_, device="cuda": (dev,) * n_  # ... one a virtual card of this card
    transfer.batch_to_device, backend._do_warmup = up_rec, warm_rec
    handoff = HandoffProbe()
    run_cfg = cfg
    try:
        for attempt in range(2):
            backend.DEFAULT_BATCH_CFG = run_cfg
            retry.BREAKER.reset()
            degraded0 = cat.DEGRADED_ROUNDS_TOTAL.value()
            cat.ROUND_PHASE_S.reset()
            snap0 = solver_cache.GLOBAL.snapshot()
            uploads.clear()
            warm_s[0] = 0.0
            sync()
            zero_counts()
            t1[0] = time.time()
            handoff.start()
            try:
                sym = SymExecWrapper(EVMContract(code=runtime.hex(), creation_code=creation, name=name),
                                     address=0x1234, strategy="cuda-batch", execution_timeout=budget,
                                     transaction_count=tx, max_depth=128)
                issues = sorted({(i.swc_id, i.address) for i in fire_lasers(sym)})
            finally:
                handoff.stop()
            sync()
            wall = time.time() - t1[0]
            e2e_counts = read_counts()
            strat = backend.find_tpu_strategy(sym.laser.strategy)
            if strat.device_rounds > 0 or run_cfg.device_engage_after_s == 0.0:
                break
            run_cfg = run_cfg._replace(device_engage_after_s=0.0)
    finally:
        mesh.n_devices, mesh.card_devices = n_devices, card_devices
        transfer.batch_to_device, backend._do_warmup = orig_up, orig_warm
        backend.DEFAULT_BATCH_CFG = cfg
        if mesh_env is None:
            os.environ.pop("MYTHRIL_TPU_MESH", None)
        else:
            os.environ["MYTHRIL_TPU_MESH"] = mesh_env
    snap = solver_cache.GLOBAL.snapshot()
    degraded = cat.DEGRADED_ROUNDS_TOTAL.value() - degraded0
    gauges = {str(s): cat.MESH_FRONTIER_OCCUPANCY.value(str(s)) for s in range(n)}
    phases = {ph: [cat.ROUND_PHASE_S.percentile(50, ph), cat.ROUND_PHASE_S.count(ph)]
              for ph in ("host_exec", "solve", "pack", "lift", "triage", "device_round")}
    expected, early = expected_issues("e2e_mesh", name, handoff.at)
    emit({"phase": "e2e_mesh", "contract": name, "tx": tx, "budget_s": budget, "shards": n, "virtual_cards": n,
          "device_engage_after_s": run_cfg.device_engage_after_s, "handoff": handoff.at,
          "handoff_before_loop": early, "issues": issues, "expected": expected, "wall_s": round(wall, 3),
          "strategy_warmup_s": round(warm_s[0], 3),
          "first_upload_s": round(uploads[0], 3) if uploads else None,
          "upload_s": [round(u, 1) for u in uploads], "device_rounds": strat.device_rounds,
          "fused_rounds": strat.fused_rounds, "fused_syncs": strat.fused_syncs,
          "device_steps_retired": strat.device_steps_retired, "device_wall_s": round(strat.device_wall_s, 3),
          "total_states": sym.laser.total_states, "steal_events": strat.mesh_steal_events,
          "steal_lanes": strat.mesh_steal_lanes, "occupancy": strat.mesh_occupancy,
          "solver_cache": {k: snap[k] - snap0[k] for k in snap if isinstance(snap[k], (int, float))
                           and isinstance(snap0.get(k), (int, float))},
          "occupancy_gauges": gauges, "round_phase_p50_s_and_count": phases, "launches": e2e_counts,
          "degraded_rounds": strat.degraded_rounds,
          "degraded_rounds_total": degraded, "breaker": retry.BREAKER.state(), "gpu": smi})
    if issues != expected:
        raise AssertionError(f"{name} over the mesh: issues {issues}, expected {expected} (handoff {handoff.at})")
    if strat.device_rounds <= 0 or strat.fused_rounds <= 0 or len(strat.mesh_occupancy) != n:
        raise AssertionError(f"{name}: no fused mesh round ran")
    if strat.degraded_rounds or degraded or retry.BREAKER.state() != "closed":
        raise AssertionError(f"{name}: a round degraded over the mesh")
    missing = [k for k in ("K1", "K4", "K6", "K7", "XC_COUNT", "XC_PLAN", "XC_PULL") if e2e_counts[k] <= 0]
    if on_card and missing:
        raise AssertionError(f"kernels the mesh analysis never launched: {missing}")
    # a fused mesh round is, on each card, K1, K3, the epilogue (K4), one
    # launch of each exchange mode and the compaction after it (K4); each
    # super-round counts once more before its first round. The one-card
    # steal kernel does not run over cards.
    if on_card and not (e2e_counts["XC_PLAN"] == e2e_counts["XC_PULL"]
                        and e2e_counts["K4"] == 2 * e2e_counts["XC_PLAN"]
                        and e2e_counts["XC_COUNT"] > e2e_counts["XC_PLAN"]
                        and (e2e_counts["XC_COUNT"] - e2e_counts["XC_PLAN"]) % n == 0
                        and e2e_counts["mesh_steal"] == 0):
        raise AssertionError(f"the mesh analysis did not run the exchange once a round on each card: {e2e_counts}")
    return e2e_counts


# (name, source, tx, budget s): the service phase's submissions. Every
# job's host phases run under the service's one host lock (invariant I2),
# released only while a job waits in a device round, and becstress is
# host-bound (one or two device rounds in its 60 s): a small job that
# loses the lock to it after a shared round waits until becstress is done,
# so the small jobs' budgets must outlast it.
SERVICE_JOBS = (
    ("killable", "killable.asm", 1, 180),
    ("originauth", "originauth.asm", 1, 180),
    ("becstress", None, 2, 60),
)
SERVICE_SWC = {"killable": ("106", "115"), "originauth": ("115", "106")}  # (must hold, must lack)


def run_service(dev, cfg, smi, workers=3, gather_window_s=1.0, compare_steps=64):
    """Phase 13: the multi-tenant service on the card, in this process, at
    ``cfg``'s width with the engagement gate open (``device_engage_after_s``
    0, ``min_device_frontier`` 0, as tests/service/test_multitenant.py opens
    it). One AnalysisService whose cache is a fleet DurableResultCache in a
    temporary directory, behind a fleet Gateway over one LocalWorker, takes
    killable (tx 1, 180 s), originauth (tx 1, 180 s) and becstress (tx 2,
    60 s) at once;
    every job must end done with its own issue set, two or more jobs must
    share a device round, no round may degrade or retry, and K1, K4, K6 and
    K7 must launch (counts zeroed just before the submissions, read once the
    last result is in). The input of the first shared round's first
    dispatch is kept and run again through run_fused and the twin, as one
    round of ``compare_steps`` steps (every job forks inside the first 30
    steps, and the round ends with K4's compaction): every plane must
    agree, every alive lane must carry one of the jobs' ids, and
    each lane the job of the state it descends from (``seed_id``), so forks
    and compaction kept job_id. Then killable again, which the durable store
    must answer in under 1% of its cold wall.

    On the card: ``python3 -c 'import chip_smoke as c, torch; from
    mythril_tpu_torch.laser.cuda import _build, batch; _build.build_all();
    c.run_service(torch.device("cuda"), batch.DEFAULT_BATCH_CFG, c.smi_line())'``"""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mythril_tpu_torch.disassembler.asm import assemble
    from mythril_tpu_torch.fleet.gateway import Gateway
    from mythril_tpu_torch.fleet.qos import AdmissionController
    from mythril_tpu_torch.fleet.store import DurableResultCache
    from mythril_tpu_torch.fleet.worker import LocalWorker
    from mythril_tpu_torch.laser.cuda import backend, batch, megakernel
    from mythril_tpu_torch.obs import catalog as cat
    from mythril_tpu_torch.robustness import retry
    from mythril_tpu_torch.service import AnalysisService

    on_card = dev.type == "cuda"
    zero_counts, read_counts = launch_counters()
    svc_cfg = cfg._replace(device_engage_after_s=0.0, min_device_frontier=0)
    codes = {}
    for name, src, _tx, _budget in SERVICE_JOBS:
        runtime = assemble(STRESS_SRC if src is None else open(os.path.join(HERE, "bench_contracts", src)).read())
        n = len(runtime)
        codes[name] = (runtime.hex(), assemble(
            f"PUSH2 {n}\nPUSH2 :code\nPUSH1 0x00\nCODECOPY\nPUSH2 {n}\nPUSH1 0x00\nRETURN\ncode:"
        ).hex() + runtime.hex())

    # the first shared round: flagged where the round's staged batch holds
    # two jobs, its first dispatch's input cloned (not counted, not synced)
    shared = {"flag": False, "kept": None, "kept_out": None, "jobs": None, "dispatch_rounds": []}
    orig_guarded, orig_fused = retry.run_round_guarded, megakernel.run_fused

    def guarded(bridge, cfg_, **kw):
        np_batch = bridge._np_batch
        if shared["kept"] is None and np_batch is not None:
            jobs = set(np_batch["job_id"][np_batch["alive"].astype(bool)].tolist()) - {0}
            if len(jobs) >= 2:
                shared["flag"], shared["jobs"] = True, sorted(jobs)
        return orig_guarded(bridge, cfg_, **kw)

    def fused(cb, env, st, max_rounds, steps_per_round=512, with_stats=False, with_solve=False, pool=None,
              device="cuda"):
        shared["dispatch_rounds"].append(int(max_rounds))
        keep = shared["flag"] and shared["kept"] is None
        if keep:
            shared["flag"] = False
            shared["kept"] = (cb, batch.StateBatch(*(x.clone() for x in st)),
                              dict(max_rounds=max_rounds, steps_per_round=steps_per_round, with_solve=with_solve,
                                   pool=pool))
        out = orig_fused(cb, env, st, max_rounds, steps_per_round, with_stats, with_solve, pool, device)
        if keep:  # the service's own output of that dispatch, every round of it
            shared["kept_out"] = (out.st.alive.clone(), out.st.job_id.clone(), out.st.seed_id.clone(),
                                  out.info.clone())
        return out

    store_dir = tempfile.mkdtemp(prefix="mt-service-")
    backend_device, backend_cfg = backend.DEVICE, backend.DEFAULT_BATCH_CFG
    backend.DEVICE, backend.DEFAULT_BATCH_CFG = dev.type, svc_cfg
    retry.BREAKER.reset()
    # the round-phase figures printed below are the phase's own (the
    # adaptive super-round depth, which reads them, starts at its default
    # as in a fresh `serve` process); nothing else of the earlier
    # analyses' process state is reset
    cat.ROUND_PHASE_S.reset()
    backend._fused_round_cost_s[0] = 0.0
    cache = DurableResultCache(store_dir)
    service = gateway = None
    try:
        backend.warmup_device(svc_cfg)
        service = AnalysisService(workers=workers, gather_window_s=gather_window_s, batch_cfg=svc_cfg, cache=cache)
        gateway = Gateway([LocalWorker("w0", service)],
                          admission=AdmissionController(base_rate_per_s=1000.0, burst=1000.0))
        gateway.start()
        retry.run_round_guarded, megakernel.run_fused = guarded, fused
        if on_card:
            torch.cuda.synchronize()
        zero_counts()
        t0 = time.time()
        gids = {}
        for name, _src, tx, budget in SERVICE_JOBS:
            runtime, creation = codes[name]
            resp = gateway.handle({"op": "submit", "code": runtime, "creation_code": creation, "name": name,
                                   "tx_count": tx, "timeout": budget})
            if not resp.get("ok"):
                raise AssertionError(f"the gateway refused {name}: {resp}")
            gids[name] = resp["job_id"]
        results, walls = {}, {}
        for name, *_ in SERVICE_JOBS:
            results[name] = gateway.handle({"op": "result", "job_id": gids[name], "timeout": 300})
            walls[name] = time.time() - t0
        if on_card:
            torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        retry.run_round_guarded, megakernel.run_fused = orig_guarded, orig_fused
        stats = service.stats()
        issues = {name: sorted({(i["swc-id"], i["address"]) for i in (r.get("result") or {}).get("issues", [])})
                  for name, r in results.items()}
        emit({"phase": "service", "workers": workers, "gather_window_s": gather_window_s, "lanes": svc_cfg.lanes,
              "wall_s": round(wall, 3), "result_s": {k: round(v, 3) for k, v in walls.items()},
              "job_wall_s": {k: r.get("wall_s") for k, r in results.items()},
              "states": {k: r.get("state") for k, r in results.items()}, "issues": issues,
              "rounds": stats["rounds"], "shared_rounds": stats["shared_rounds"],
              "max_resident_jobs": stats["max_resident_jobs"], "degraded_rounds": stats["degraded_rounds"],
              "device_retries": stats["device_retries"], "breaker": stats["breaker_state"],
              "dispatch_rounds": shared["dispatch_rounds"],
              "round_phase_p50_s_and_count": {ph: [cat.ROUND_PHASE_S.percentile(50, ph), cat.ROUND_PHASE_S.count(ph)]
                                              for ph in ("host_exec", "solve", "pack", "lift", "device_round")},
              "launches": {k: counts[k] for k in ("K1", "K1_steps", "K3", "K4", "K5", "K6", "K7")}, "gpu": smi})
        for name, r in results.items():
            if not r.get("ok") or r.get("state") != "done":
                raise AssertionError(f"service job {name} did not end done: {r}")
            if any(i["contract"] != name for i in r["result"]["issues"]):
                raise AssertionError(f"service job {name} reported under another name: {r['result']['issues']}")
        for name, (want, lack) in SERVICE_SWC.items():
            swcs = set(results[name]["result"]["swc_ids"])
            if want not in swcs or lack in swcs:
                raise AssertionError(f"service job {name}: SWC {sorted(swcs)}, want {want} and not {lack}")
        if issues["becstress"] != EXPECTED_ISSUES["becstress"]:
            raise AssertionError(f"service becstress: {issues['becstress']}, want {EXPECTED_ISSUES['becstress']}")
        if stats["max_resident_jobs"] < 2 or stats["shared_rounds"] < 1:
            raise AssertionError(f"no device round held two jobs: {stats}")
        if stats["degraded_rounds"] or stats["device_retries"] or stats["breaker_state"] != "closed":
            raise AssertionError(f"a shared round degraded or retried: {stats}")
        missing = [k for k in ("K1", "K4", "K6", "K7") if counts[k] <= 0]
        if on_card and missing:
            raise AssertionError(f"kernels the service phase never launched: {missing}")

        # the first shared round again, through the kernels and the twin
        if shared["kept"] is None:
            raise AssertionError("no shared round's dispatch was kept")
        cb, st, kw = shared["kept"]
        svc_rounds = (int(kw["max_rounds"]), int(kw["steps_per_round"]))
        # one round of compare_steps: the twin took 39 s for two rounds of 256 steps at 512 lanes
        kw = dict(kw, max_rounds=1, steps_per_round=compare_steps)
        out_k = megakernel.run_fused(cb, None, st, device=dev, **kw)
        out_t = megakernel.run_fused_plain(cb, st, kw["max_rounds"], kw["steps_per_round"], kw["with_solve"],
                                           kw["pool"])
        differ = [f for f, x, y in zip(batch.StateBatch._fields, out_k.st, out_t.st) if not torch.equal(x, y)]
        if not torch.equal(out_k.info, out_t.info):
            differ.append("info")
        wids = sorted(int(g.rpartition(":")[2]) for g in gids.values())
        staged = st.alive.cpu().numpy().astype(bool)
        job_of_seed = {}
        for seed, job in zip(st.seed_id.cpu().numpy()[staged].tolist(), st.job_id.cpu().numpy()[staged].tolist()):
            job_of_seed.setdefault(seed, set()).add(job)

        def lane_jobs(alive, job_id, seed_id, info):
            """(foreign job ids, lanes off their seed's job, forks) of an output"""
            alive = alive.cpu().numpy().astype(bool)
            jobs, seeds = job_id.cpu().numpy()[alive], seed_id.cpu().numpy()[alive]
            foreign = sorted(set(jobs.tolist()) - set(wids))
            orphans = int(sum(job_of_seed.get(int(sd)) != {int(jb)} for sd, jb in zip(seeds, jobs)))
            info = megakernel.decode_info(info)
            return foreign, orphans, int(alive.sum()) + info.pruned_lanes + info.inloop_kills - int(staged.sum())

        # the service's own output of the whole dispatch, and the replay
        svc_foreign, svc_orphans, svc_forked = lane_jobs(*shared["kept_out"])
        foreign, orphans, forked = lane_jobs(out_k.st.alive, out_k.st.job_id, out_k.st.seed_id, out_k.info)
        emit({"phase": "service_shared_round", "jobs_staged": shared["jobs"], "job_ids": wids,
              "lanes_staged": int(staged.sum()),
              "service_dispatch": {"rounds": svc_rounds[0], "steps_per_round": svc_rounds[1],
                                   "lanes_alive_after": int(shared["kept_out"][0].sum()), "forked": svc_forked,
                                   "foreign_job_ids": svc_foreign, "lanes_off_their_seed_job": svc_orphans},
              "replay": {"rounds": kw["max_rounds"], "steps_per_round": kw["steps_per_round"],
                         "with_solve": kw["with_solve"], "lanes_alive_after": int(out_k.st.alive.sum()),
                         "forked": forked, "planes_differ": differ, "foreign_job_ids": foreign,
                         "lanes_off_their_seed_job": orphans}})
        if (differ or foreign or orphans or forked <= 0 or svc_foreign or svc_orphans or svc_forked <= 0
                or not set(shared["jobs"]) <= set(wids)):
            raise AssertionError(f"the shared round: planes {differ}, foreign job ids {foreign} (service "
                                 f"{svc_foreign}), {orphans} lanes off their seed's job (service {svc_orphans}), "
                                 f"{forked} forks (service {svc_forked})")

        # a warm resubmission from the durable store
        runtime, creation = codes["killable"]
        t1 = time.time()
        resp = gateway.handle({"op": "submit", "code": runtime, "creation_code": creation, "name": "killable",
                               "tx_count": SERVICE_JOBS[0][2], "timeout": SERVICE_JOBS[0][3]})
        warm = gateway.handle({"op": "result", "job_id": resp["job_id"], "timeout": 30})
        warm_s = time.time() - t1
        cold_s = walls["killable"]
        emit({"phase": "service_warm", "cache_hit": warm.get("cache_hit"), "warm_s": round(warm_s, 6),
              "cold_s": round(cold_s, 3), "ratio": round(warm_s / cold_s, 6), "store": cache.stats().get("store")})
        if not warm.get("cache_hit") or warm["result"]["issues"] != results["killable"]["result"]["issues"]:
            raise AssertionError(f"the resubmission was no cache hit with the same issues: {warm}")
        if warm_s >= 0.01 * cold_s:
            raise AssertionError(f"the warm answer took {warm_s:.4f} s, not under 1% of the cold {cold_s:.3f} s")
        print(f"service: wall {wall:.3f} s, rounds {stats['rounds']}, shared rounds {stats['shared_rounds']}, "
              f"max resident jobs {stats['max_resident_jobs']}, launches "
              + " ".join(f"{k} {counts[k]}" for k in ("K1", "K3", "K4", "K5", "K6", "K7")), flush=True)
        print(smi, flush=True)
        return counts
    finally:
        retry.run_round_guarded, megakernel.run_fused = orig_guarded, orig_fused
        if gateway is not None:
            gateway.stop()
        if service is not None:
            service.shutdown(wait=True, timeout=60)
        cache.close()
        shutil.rmtree(store_dir, ignore_errors=True)
        backend.DEVICE, backend.DEFAULT_BATCH_CFG = backend_device, backend_cfg


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # noqa: BLE001 - report any phase's failure and exit non-zero
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
