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
   and BECToken batches (every plane after every step), K3 on a seeded
   random pool, K4 on a batch with mixed alive/REVERT/killed lanes;
3. the main path at DEFAULT_BATCH_CFG (512 lanes, code_len 8192):
   run_fused(max_rounds=16, steps_per_round=256, with_solve=True) on
   becstress, BECToken and the in-loop demo, with every launch counter
   zeroed just before and read just after, no host sync allowed inside
   the super-round (torch's sync debug mode raises on one), and each
   result compared with the twin's fused run on the same inputs;
4. per-kernel times on the card against the twin's and a bound.

The last three lines are the kernels JSON, the card's name and power
limit, and {"ok": true, "device": {...}}. Any mismatch or exception
exits non-zero without that last line. Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
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
    print(json.dumps(obj), flush=True)


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
    run(torch.device("cuda"), batch.DEFAULT_BATCH_CFG, smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def run(dev, cfg, smi, k1_steps=64, rounds=16, steps_per_round=256):
    """Phases 2-4 on ``dev`` at ``cfg`` (the card at DEFAULT_BATCH_CFG;
    a CPU rehearsal at a small config runs the same flow on the twins)."""
    import numpy as np
    import torch

    from mythril_tpu_torch.disassembler.asm import assemble
    from mythril_tpu_torch.laser.cuda import batch, convert, engine, inloop_solve, keccak, kernels, megakernel
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
        st_k = batch.build_batch(cfg, seeds(n_cmp, n_cmp), device=dev)
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

    def random_pool_case(seed):
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
        V, C, W = inloop_solve.POOL_VARS, inloop_solve.POOL_CLAUSES, inloop_solve.POOL_WIDTH
        vsel = r.integers(0, 48, V)
        pool = convert.pool_to_torch(dict(
            var_h1=hs[vsel, 0], var_h2=hs[vsel, 1],
            lit_var=r.integers(0, V, (C, W)).astype(np.int32),
            lit_neg=r.random((C, W)) < 0.5, lit_used=r.random((C, W)) < 0.3,
        ), dev)
        return st, pool

    k3_case = random_pool_case(7)
    flagged = 0
    for seed in (7, 8, 9):
        st, pool = k3_case if seed == 7 else random_pool_case(seed)
        km = inloop_solve.unsat_mask(pool, st, device=dev)
        tm = inloop_solve.unsat_mask_plain(pool, st)
        if not torch.equal(km, tm):
            raise AssertionError(f"K3 differs from the twin on pool seed {seed}")
        flagged += int(km.sum())
    emit({"phase": "compare", "kernel": "K3", "cases": 3, "lanes": cfg.lanes, "flagged": flagged, "ok": True})

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

    cb4, st4, unsat4 = mixed_epilogue_case(11)
    acc_t = torch.zeros(4, dtype=torch.int32, device=dev)
    pv_t = torch.zeros(cb4.code.shape, dtype=torch.bool, device=dev)
    out_t = megakernel.round_epilogue_plain(cb4, st4, unsat4, acc_t, pv_t)
    st_k4 = batch.StateBatch(*(x.clone() for x in st4))
    acc_k = torch.zeros(4, dtype=torch.int32, device=dev)
    pv_k = torch.zeros_like(pv_t)
    ctl = torch.tensor([0, 1, 0, 0], dtype=torch.int32, device=dev)
    scratch = batch.StateBatch(*(torch.empty_like(x) for x in st4))
    if on_card:
        megakernel.round_epilogue(cb4, st_k4, unsat4, acc_k, pv_k, ctl, 16, scratch)
    else:  # the rehearsal has no kernel: apply the twin and its control word
        st_k4 = megakernel.round_epilogue_plain(cb4, st_k4, unsat4, acc_k, pv_k)
        ctl[:2] = torch.tensor([1, int((st_k4.alive & (st_k4.status == 0)).any())])
    same, err = planes_equal(st_k4, out_t)
    cont_t = int((out_t.alive & (out_t.status == 0)).any())
    ok_k4 = same and torch.equal(acc_k, acc_t) and torch.equal(pv_k, pv_t) and ctl[:2].tolist() == [1, cont_t]
    max_err["K4"] = err
    emit({"phase": "compare", "kernel": "K4", "lanes": cfg.lanes, "acc": acc_k.tolist(),
          "dying": int(acc_k[0] + acc_k[3]), "ctl": ctl.tolist(), "ok": bool(ok_k4)})
    if not ok_k4:
        raise AssertionError(f"K4 differs from the twin: {first_diff(st_k4, out_t)} acc {acc_k.tolist()} vs {acc_t.tolist()}")

    # ---- 3. the main path ----------------------------------------------
    n_seeds = min(16, cfg.lanes // 4)
    inputs = {}
    for name, code in contracts.items():
        specs = [dict(sym) for _ in range(n_seeds // 2)] + seeds(0, n_seeds // 2)
        inputs[name] = (bank_for(code), batch.build_batch(cfg, specs, device=dev))
    pool0 = inloop_solve.empty_pool(dev)
    sync()
    engine.launches = keccak.launches = inloop_solve.launches = megakernel.launches = 0
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
    counts = {"K1": engine.launches, "K2": keccak.launches, "K3": inloop_solve.launches,
              "K4": megakernel.launches}
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
    if on_card and min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {counts}")
    for name, (cb, st) in inputs.items():
        out_k = results[name][0]
        out_t = megakernel.run_fused_plain(cb, st, rounds, steps_per_round, True, pool0)
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
    def time_ms(fn, prep=None, reps=20):
        """Mean device time of fn over reps (CUDA events); the rehearsal
        reports host time, which is no device figure and is not kept."""
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

    ms_k1 = time_ms(lambda a: engine.step(cb1, None, a[0], device=dev, inplace=True, args=a[1]), clone1)
    plain_k1 = time_ms(lambda a: engine.step_plain(cb1, a[0]), clone1, reps=5)
    after = engine.step(cb1, None, st1, device=dev)
    running = int((st1.alive & (st1.status == 0)).sum())
    children = int(after.alive.sum() - st1.alive.sum())
    # per running lane: fetch byte, 7 scalar planes read, top-3 words and
    # tags read, 6 scalars + one word and tag written, the visited byte;
    # each child needs its whole row written
    bytes_k1 = running * (1 + 7 * 4 + 3 * 68 + 6 * 4 + 68 + 1) + children * row_bytes(st1)

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
    ms_k3 = time_ms(lambda _: inloop_solve.unsat_mask(pool3, st3, device=dev))
    plain_k3 = time_ms(lambda _: inloop_solve.unsat_mask_plain(pool3, st3), reps=5)
    elig = st3.alive & (st3.status == 0)
    valid_entries = int(torch.minimum(st3.path_len, torch.tensor(cfg.path_slots, device=dev))[elig].sum())
    pool_bytes = sum(x.numel() * x.element_size() for x in pool3)
    bytes_k3 = int(elig.sum()) * (cfg.path_slots * 5 + 4) + valid_entries * 16 + pool_bytes + L * (1 + 4 + 1)

    def prep4():
        return (batch.StateBatch(*(x.clone() for x in st4)), torch.zeros(4, dtype=torch.int32, device=dev),
                torch.zeros_like(pv_t), torch.tensor([0, 1, 0, 0], dtype=torch.int32, device=dev))

    if on_card:
        ms_k4 = time_ms(lambda a: megakernel.round_epilogue(cb4, a[0], unsat4, a[1], a[2], a[3], 16, scratch), prep4)
    else:
        ms_k4 = time_ms(lambda a: megakernel.round_epilogue_plain(cb4, a[0], unsat4, a[1], a[2]), prep4)
    plain_k4 = time_ms(lambda a: megakernel.round_epilogue_plain(cb4, a[0], unsat4, a[1], a[2]), prep4, reps=5)
    order = torch.argsort((st4.alive & ~(megakernel.prune_mask(cb4, st4) | unsat4)).to(torch.int32),
                          descending=True, stable=True)
    moved = int((order != torch.arange(L, device=dev)).sum())
    dying_n = int(acc_k[0] + acc_k[3])
    bytes_k4 = L * (1 + 4 + 4 + 1 + 1 + 4 + 4) + moved * 2 * row_bytes(st4) + dying_n * 2 * cfg.code_len

    def entry(kid, name, source, replaces, ms, plain, nbytes):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": counts[kid], "max_abs_err": max_err[kid], "ms": round(ms, 6),
                "plain_ms": round(plain, 6), "bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 9),
                "bound_by": "bytes", "library_ms": None}

    kernels_line = {"kernels": [
        entry("K1", "K1 step", "mythril_tpu_torch/csrc/step.cu", "mythril_tpu/laser/tpu/engine.py:118",
              ms_k1, plain_k1, bytes_k1),
        entry("K2", "K2 keccak256_batch", "mythril_tpu_torch/csrc/keccak.cu",
              "mythril_tpu/laser/tpu/keccak_tpu.py:126", ms_k2, plain_k2, bytes_k2),
        entry("K3", "K3 unsat_mask", "mythril_tpu_torch/csrc/inloop.cu",
              "mythril_tpu/laser/tpu/inloop_solve.py:123", ms_k3, plain_k3, bytes_k3),
        entry("K4", "K4 round_epilogue", "mythril_tpu_torch/csrc/megakernel.cu",
              "mythril_tpu/laser/tpu/megakernel.py:204", ms_k4, plain_k4, bytes_k4),
    ]}
    emit({"phase": "timing", "k1_state": {"running": running, "children": children},
          "k4_state": {"moved": moved, "dying": dying_n}, "gpu": smi})
    emit(kernels_line)
    print(smi, flush=True)


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # noqa: BLE001 - report any phase's failure and exit non-zero
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
