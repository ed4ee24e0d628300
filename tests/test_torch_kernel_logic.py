"""The CUDA kernels' own lane logic against the plain twins, on the CPU.

The kernels cannot run here (no card, no nvcc), but their per-lane code
in ``mythril_tpu_torch/csrc/*.cuh`` is plain C++ over pointers: compiled
as host C++ (``csrc/host_emu.cpp``, g++), with loops over lanes standing
in for the grids, it runs on CPU tensors. These tests hold that code bit
for bit against the twins, which test_torch_fused.py holds against the
JAX reference. On the card, chip_smoke.py does the same with the real
kernels."""

import ctypes
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as hst

import bench
from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.laser.cuda import _build, batch, convert, engine, inloop_solve, keccak, kernels, megakernel
from mythril_tpu_torch.support.keccak import keccak256

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = batch.BatchConfig(lanes=16, stack_slots=32, memory_bytes=256, calldata_bytes=128, storage_slots=8,
                        code_len=512, tape_slots=64, path_slots=16, mem_sym_slots=8, ss_ring=16)
HOST_OPS = (0x00, 0xF3, 0xFD, 0xFF, 0xFE)
SYM = dict(symbolic_calldata=True, symbolic_storage=True, symbolic_caller=True, symbolic_callvalue=True)
SOURCES = {
    "stress": bench.STRESS_SRC,
    "bectoken": open(os.path.join(ROOT, "bench_contracts", "bectoken.asm")).read(),
    "inloop_demo": bench.INLOOP_DEMO_SRC,
}


@pytest.fixture(scope="module")
def emu():
    return _build.host_emulation()


def _vp(t):
    return ctypes.c_void_p(t.data_ptr())


def _emu_k1(lib, cb, st, n_steps, n_shards=1, order=None, nthreads=128, ctl=None, hist=None):
    """One emulated K1 launch of ``n_steps`` steps on a copy of ``st``;
    with ``hist`` (int32[256], added into in place) its stats instance."""
    st = batch.StateBatch(*(x.clone() for x in st))
    sc = kernels.Scratch.get(torch.device("cpu"), st.pc.shape[0])
    pl = kernels.planes(st, cb.code.shape[0], cb.code.shape[1])
    bk = kernels.bank(cb)
    order = None if order is None else torch.as_tensor(order, dtype=torch.int32)
    rc = lib.emu_step_run(ctypes.byref(pl), ctypes.byref(bk), _vp(sc.tab), _vp(sc.flags),
                          _vp(ctl) if ctl is not None else None, _vp(hist) if hist is not None else None,
                          _vp(sc.hrec) if hist is not None else None, n_shards, n_steps, nthreads,
                          _vp(order) if order is not None else None)
    assert rc == 0
    return st


def _emu_step(lib, cb, st):
    return _emu_k1(lib, cb, st, 1)


def _emu_unsat(lib, st, pool, reverse=0):
    """One emulated K3 launch (one warp a lane, its threads in ascending
    or descending order between the warp's barriers)."""
    out = torch.zeros(st.pc.shape[0], dtype=torch.bool)
    pl = kernels.planes(st, 1, st.visited.shape[1])
    assert lib.emu_unsat(ctypes.byref(pl), ctypes.byref(kernels.pool_struct(pool)), _vp(out), reverse) == 0
    return out


def _emu_epilogue(lib, cb, s, scratch, unsat, acc, pv, ctl, max_rounds, n=1, flags=kernels.EPI_COMMIT,
                  gate=None, nblocks=2, nthreads=64, reverse=0):
    """One emulated K4 launch on ``s`` in place, ``nblocks`` blocks of
    ``nthreads`` threads, each part's threads in either order."""
    sc = kernels.Scratch.get(torch.device("cpu"), s.pc.shape[0])
    pl = kernels.planes(s, cb.code.shape[0], cb.code.shape[1])
    psc = kernels.planes(scratch, cb.code.shape[0], cb.code.shape[1])
    assert lib.emu_epilogue(ctypes.byref(pl), ctypes.byref(psc), _vp(cb.prune_revert), _vp(unsat), _vp(acc),
                            _vp(sc.order), _vp(sc.dying), _vp(sc.eflags), _vp(pv), _vp(ctl), max_rounds, n, flags,
                            _vp(gate) if gate is not None else None, nblocks, nthreads, reverse) == 0
    return sc


def _assert_same(a, b, where):
    for name, x, y in zip(batch.StateBatch._fields, a, b):
        if not torch.equal(x, y):
            idx = tuple((x != y).nonzero()[0].tolist())
            raise AssertionError(f"{where}: {name}{list(idx)} kernel={x[idx].item()} twin={y[idx].item()}")


def _inputs(name, seed):
    rng = np.random.default_rng(seed)
    conc = [dict(calldata=int(rng.integers(1, 1 << 30)).to_bytes(32, "big") + int(rng.integers(0, 4)).to_bytes(32, "big")
                 + bytes(rng.integers(0, 256, 40, dtype=np.uint8)), caller=0x1000 + i) for i in range(2)]
    cb = batch.make_code_bank([assemble(SOURCES[name])], CFG.code_len, host_ops=HOST_OPS, freeze_errors=True,
                              record_storage_events=True, prune_revert=True, device="cpu")
    return cb, batch.build_batch(CFG, [dict(SYM), dict(SYM)] + conc, device="cpu")


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_step_lane_logic_matches_twin(emu, name):
    cb, st = _inputs(name, 5)
    se = st
    for i in range(60):
        st = engine.step_plain(cb, st)
        se = _emu_step(emu, cb, se)
        _assert_same(se, st, f"{name} step {i}")
    assert int(st.alive.sum()) > 4


def _twin_slots(free, req, n):
    """engine.step_plain's fork placement (its cumsum ranks per lane
    block) as slot codes: the child lane, -1 (no request) or -2 (the
    block has no free lane left: fork_no_slot)."""
    L = free.shape[0]
    per = L // n
    lane = torch.arange(L)
    base = (lane // per) * per
    nfree = free.to(torch.int64).view(n, per).sum(1).repeat_interleave(per)
    free_rank = (torch.cumsum(free.to(torch.int64).view(n, per), 1) - 1).reshape(L)
    req_rank = (torch.cumsum(req.to(torch.int64).view(n, per), 1) - 1).reshape(L)
    has_slot = req & (req_rank < nfree)
    free_by_rank = torch.zeros(L, dtype=torch.int64)
    free_by_rank[base[free] + free_rank[free]] = lane[free]
    child = free_by_rank[base + req_rank.clamp(0, per - 1)]
    return torch.where(has_slot, child, torch.where(req, -2, -1)).to(torch.int32)


@settings(max_examples=60, deadline=None, database=None)
@given(L=hst.sampled_from([8, 64, 512, 1024]), n=hst.sampled_from([1, 2, 8]), nthreads=hst.sampled_from([32, 128, 1024]),
       p=hst.sampled_from([(0.0, 0.7), (0.5, 0.4), (0.1, 0.6), (1.0, 0.0), (0.3, 0.0), (0.05, 0.9)]),
       seed=hst.integers(0, 2**32 - 1))
@example(L=64, n=8, nthreads=128, p=(0.0, 0.7), seed=1)  # no free lane: every request SLOT_FULL
@example(L=1024, n=1, nthreads=128, p=(0.05, 0.9), seed=2)  # more requests than free lanes
def test_fork_rank_scan_matches_twin_cumsum(L, n, nthreads, p, seed):
    """K1's rank (the scan in csrc/step.cuh, run thread by thread between
    its barriers) against the twin's cumsum placement, on random lanes:
    free, running with or without a fork request, or halted."""
    lib = _build.host_emulation()
    r = np.random.default_rng(seed)
    p_free, p_req = p
    u = r.random(L)
    free = torch.as_tensor(u < p_free)
    running = torch.as_tensor((u >= p_free) & (r.random(L) < 0.8))
    req = running & torch.as_tensor(r.random(L) < p_req)
    flags = (free.to(torch.uint8) | (req.to(torch.uint8) << 1) | (running.to(torch.uint8) << 2)).contiguous()
    slot = torch.full((L,), 7, dtype=torch.int32)
    any_running = torch.zeros(1, dtype=torch.int32)
    assert lib.emu_fork_rank(L, n, _vp(flags), nthreads, _vp(slot), _vp(any_running)) == 0
    want = _twin_slots(free, req, n)
    assert torch.equal(slot, want), (slot != want).nonzero()[:4].tolist()
    assert bool(any_running[0]) == bool(running.any())


@pytest.mark.parametrize("name", ["stress", "bectoken"])
def test_step_run_launch_matches_twin_steps(emu, name):
    """One emulated K1 launch of 64 steps against 64 twin steps, every
    plane equal, with blocks of 32 and 128 threads and the lanes' warps
    in either order, and a stopped loop's launch touching nothing."""
    cb, st = _inputs(name, 5)
    want = st
    for _ in range(64):
        want = engine.step_plain(cb, want)
    assert int(want.alive.sum()) > int(st.alive.sum())  # forks happened
    backwards = list(range(st.pc.shape[0]))[::-1]
    for nthreads, order in ((128, None), (32, None), (128, backwards)):
        got = _emu_k1(emu, cb, st, 64, order=order, nthreads=nthreads)
        _assert_same(got, want, f"{name} nthreads={nthreads} order={order}")
    stopped = _emu_k1(emu, cb, st, 64, ctl=torch.tensor([3, 0, 0, 0], dtype=torch.int32))
    _assert_same(stopped, st, f"{name} stopped")


@pytest.mark.parametrize("n_shards", [1, 2])
def test_fork_copy_before_child_lane_pass(emu, n_shards):
    """A step where several parents fork: the warps' order decides
    whether a parent's copy lands in its child before the child's own
    lane pass. The child must be skipped by the step's free flag either
    way, so every order gives the twin's step, with forks placed over
    all lanes or per lane block."""
    cb, st = _inputs("stress", 5)
    for _ in range(60):
        nxt = engine.step_plain(cb, st, n_shards)
        children = (~st.alive & nxt.alive).nonzero().flatten().tolist()
        if len(children) >= 2:
            break
        st = nxt
    assert len(children) >= 2
    alive_first = st.alive.nonzero().flatten().tolist() + (~st.alive).nonzero().flatten().tolist()
    for order in (alive_first, alive_first[::-1], None):
        got = _emu_k1(emu, cb, st, 1, n_shards, order=order)
        _assert_same(got, nxt, f"order {order}")


def test_keccak_logic_matches_twin_and_host(emu):
    lens = [0, 1, 31, 32, 135, 136, 137, 271, 272, 273, 543, 544]
    data = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (len(lens), 544), dtype=np.uint8))
    ln = torch.tensor(lens, dtype=torch.int32)
    out = torch.zeros((len(lens), 32), dtype=torch.uint8)
    assert emu.emu_keccak(_vp(data), _vp(ln), _vp(out), len(lens), 544, keccak.default_max_blocks(544)) == 0
    assert torch.equal(out, keccak.keccak256_plain(data, ln))
    for i, n in enumerate(lens):
        assert bytes(out[i].numpy()) == keccak256(bytes(data[i, :n].numpy()))


@pytest.mark.parametrize("seed", range(4))
def test_unsat_logic_matches_twin(emu, seed):
    r = np.random.default_rng(seed)
    L, P, T = 48, 12, 24
    cfg = batch.BatchConfig(lanes=L, stack_slots=4, memory_bytes=32, calldata_bytes=32, storage_slots=2,
                            code_len=64, tape_slots=T, path_slots=P, mem_sym_slots=2, ss_ring=4)
    hs = r.integers(0, 2**32, (10, 2), dtype=np.uint64).astype(np.uint32)
    pick = r.integers(0, 10, (L, T))
    st = batch.empty_batch(cfg, device="cpu")._replace(
        alive=torch.as_tensor(r.random(L) < 0.9), status=torch.as_tensor(r.choice([0, 0, 5], L).astype(np.int32)),
        path_len=torch.as_tensor(r.integers(0, P + 1, L).astype(np.int32)),
        path_id=torch.as_tensor(r.integers(0, T + 3, (L, P)).astype(np.int32)),
        path_sign=torch.as_tensor(r.random((L, P)) < 0.5),
        tape_op=torch.as_tensor(np.where(r.random((L, T)) < 0.1 * seed, 32, 10).astype(np.int32)),
        tape_a=torch.as_tensor(r.integers(-1, T + 1, (L, T)).astype(np.int32)),
        tape_h1=torch.as_tensor(hs[pick, 0].view(np.int32)), tape_h2=torch.as_tensor(hs[pick, 1].view(np.int32)),
    )
    V, C, W = 64, 64, 8
    vsel = r.integers(0, 10, V)
    pool = convert.pool_to_torch(dict(
        var_h1=hs[vsel, 0], var_h2=hs[vsel, 1], lit_var=r.integers(-2, V + 2, (C, W)).astype(np.int32),
        lit_neg=r.random((C, W)) < 0.5, lit_used=r.random((C, W)) < 0.2 + 0.05 * seed), "cpu")
    want = inloop_solve.unsat_mask_plain(pool, st)
    for reverse in (0, 1):
        assert torch.equal(_emu_unsat(emu, st, pool, reverse), want)
    assert want.any() and not want.all()


def _emu_hist(lib, cb, before, after, hist):
    n_codes, CL = cb.code.shape
    assert lib.emu_op_hist(_vp(cb.code), n_codes, CL, _vp(before.code_id), _vp(before.pc), _vp(before.steps),
                           _vp(after.steps), after.steps.shape[0], _vp(hist)) == 0


def _emu_fused(lib, cb, st, max_rounds, steps_per_round, with_solve, pool, with_stats=False):
    """run_fused's card loop, with the emulated kernels: one K1 launch a
    round (with stats its stats instance), K3, K4."""
    L = st.pc.shape[0]
    s = batch.StateBatch(*(x.clone() for x in st))
    hist = torch.zeros(256 if with_stats else 1, dtype=torch.int32)
    scratch = batch.StateBatch(*(torch.empty_like(x) for x in s))
    ctl = torch.zeros(4, dtype=torch.int32)
    ctl[1] = int(bool((s.alive & (s.status == 0)).any()) and max_rounds > 0)
    acc = torch.zeros(4, dtype=torch.int32)
    pv = torch.zeros(cb.code.shape, dtype=torch.bool)
    for _ in range(max_rounds):
        for x, y in zip(s, _emu_k1(lib, cb, s, steps_per_round, ctl=ctl, hist=hist if with_stats else None)):
            x.copy_(y)
        unsat = torch.zeros(L, dtype=torch.bool)
        if with_solve and ctl[1]:
            unsat = _emu_unsat(lib, s, pool)
        _emu_epilogue(lib, cb, s, scratch, unsat, acc, pv, ctl, max_rounds)
    return s, megakernel._info(ctl[0], acc, s), pv, hist


@pytest.mark.parametrize("with_solve", [True, False], ids=["solve_on", "solve_off"])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_fused_loop_logic_matches_twin(emu, name, with_solve):
    cb, st = _inputs(name, 9)
    pool = inloop_solve.empty_pool("cpu")
    want = megakernel.run_fused(cb, None, st, max_rounds=4, steps_per_round=24, with_solve=with_solve,
                                with_stats=with_solve, device="cpu")
    s, info, pv, hist = _emu_fused(emu, cb, st, 4, 24, with_solve, pool, with_stats=with_solve)
    _assert_same(s, want.st, f"{name} fused")
    assert torch.equal(info, want.info) and torch.equal(pv, want.pruned_visited)
    if with_solve:  # stats on: the histogram folded inside K1's launches
        assert torch.equal(hist, want.hist) and int(hist.sum()) > 0


def test_op_hist_logic_matches_twin(emu):
    """K8's lane logic on code ids, pcs and step counters out of range."""
    r = np.random.default_rng(6)
    L = 96
    code = torch.as_tensor(r.integers(0, 256, (3, 64), dtype=np.uint8))
    cb = batch.CodeBank(*([None] * len(batch.CodeBank._fields)))._replace(code=code)
    before = SimpleNamespace(code_id=torch.as_tensor(r.choice([-7, -4, -1, 0, 2, 3, 1 << 30], L).astype(np.int32)),
                             pc=torch.as_tensor(r.choice([-(1 << 31), -1, 0, 63, 64, 900], L).astype(np.int32)),
                             steps=torch.as_tensor(r.choice([-(1 << 31), -1, 0, 7, (1 << 31) - 1], L).astype(np.int32)))
    after = SimpleNamespace(steps=(before.steps.to(torch.int64) + torch.as_tensor(r.integers(-1, 2, L))).to(torch.int32))
    hist0 = torch.as_tensor(r.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32).view(np.int32))
    want = engine.op_hist_update_plain(cb, before, after, hist0)
    hist = hist0.clone()
    _emu_hist(emu, cb, before, after, hist)
    assert torch.equal(hist, want) and not torch.equal(hist, hist0)


def _emu_run(lib, cb, st, max_steps, with_stats):
    """engine.run_with_stats's card loop, with the emulated kernel: one K1
    launch of ``max_steps`` steps (with stats its stats instance)."""
    hist = torch.zeros(256 if with_stats else 1, dtype=torch.int32)
    return _emu_k1(lib, cb, st, max_steps, hist=hist if with_stats else None), hist


def _emu_slice_ctl_chain(lib, cb, st, max_steps):
    """K9 before each one-step K1 launch behind its control word: the
    condition K9 commits, step by step. Returns the batch and ``ctl``."""
    s = batch.StateBatch(*(x.clone() for x in st))
    ctl = torch.zeros(4, dtype=torch.int32)
    for _ in range(max_steps):
        assert lib.emu_slice_ctl(_vp(s.alive), _vp(s.status), s.alive.shape[0], _vp(ctl), max_steps) == 0
        for x, y in zip(s, _emu_k1(lib, cb, s, 1, ctl=ctl)):
            x.copy_(y)
    return s, ctl


def _short_inputs():
    """Every lane halts after four steps."""
    cb = batch.make_code_bank([assemble("PUSH1 0x01\nPUSH1 0x02\nADD\nSTOP")], CFG.code_len, host_ops=HOST_OPS,
                              freeze_errors=True, device="cpu")
    return cb, _inputs("stress", 3)[1]


@pytest.mark.parametrize("name", [*sorted(SOURCES), "short"])
def test_slice_loop_logic_matches_twin(emu, name):
    """The slice as one K1 launch of max_steps steps against the twin's
    loop, stats on and off (every plane and the histogram), on slices
    that hit max_steps and one that every lane leaves early; and K9's
    control word, committed before each step, against its twin's."""
    cb, st = _short_inputs() if name == "short" else _inputs(name, 3)
    for with_stats in (True, False):
        want, want_hist = engine.run_plain(cb, st, 40, with_stats)
        s, hist = _emu_run(emu, cb, st, 40, with_stats)
        _assert_same(s, want, f"{name} slice")
        assert torch.equal(hist, want_hist)
    # K9's twin commits the same control word
    s, ctl = _emu_slice_ctl_chain(emu, cb, st, 40)
    _assert_same(s, want, f"{name} K9 chain")
    ctl_t = torch.zeros(4, dtype=torch.int32)
    s_t = st
    for _ in range(40):
        engine.slice_ctl_plain(s_t, ctl_t, 40)
        if ctl_t[1]:
            s_t = engine.step_plain(cb, s_t)
    assert torch.equal(ctl, ctl_t)
    ran = int(ctl[0])
    assert (ran < 40) == (name == "short") and ran > 0
    assert bool(ctl[2]) == bool((s.alive & (s.status == 0)).any())


def test_epilogue_logic_on_mixed_lanes(emu):
    """Alive, REVERT-pruned and in-loop-killed lanes in one round, with
    the launch's parts run in either thread order."""
    cb, st = _inputs("stress", 2)
    for _ in range(30):
        st = engine.step_plain(cb, st)
    r = np.random.default_rng(4)
    L = CFG.lanes
    pick = torch.as_tensor(r.random(L))
    status = st.status.clone()
    status[pick < 0.2] = batch.REVERTED
    st = st._replace(status=status, alive=st.alive | torch.as_tensor(r.random(L) < 0.3),
                     steps=torch.as_tensor(r.integers(0, 100, L).astype(np.int32)))
    unsat = torch.as_tensor(r.random(L) < 0.3) & st.alive
    acc_t = torch.zeros(4, dtype=torch.int32)
    pv_t = torch.zeros(cb.code.shape, dtype=torch.bool)
    want = megakernel.round_epilogue_plain(cb, st, unsat, acc_t, pv_t)
    assert int(acc_t[0]) > 0 and int(acc_t[3]) > 0  # both prune and kill happened
    for reverse in (0, 1):
        s = batch.StateBatch(*(x.clone() for x in st))
        scratch = batch.StateBatch(*(torch.empty_like(x) for x in s))
        acc = torch.zeros(4, dtype=torch.int32)
        pv = torch.zeros_like(pv_t)
        ctl = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
        _emu_epilogue(emu, cb, s, scratch, unsat, acc, pv, ctl, 16, reverse=reverse)
        _assert_same(s, want, f"epilogue reverse={reverse}")
        assert torch.equal(acc, acc_t) and torch.equal(pv, pv_t)
        assert ctl[:2].tolist() == [1, int((want.alive & (want.status == 0)).any())]


def _pool_state(seed, L=48, P=12, T=24, V=64, C=64, W=8, case=""):
    """A random K3 input at (L, P, T) with a (V, C, W) pool: lanes with
    random alive/status flags, path entries naming random tape nodes whose
    hashes come from a small set, so that the pool's vars match some.
    Every clause has at least two literals, so that what a lane's path
    seeds decides whether propagation conflicts."""
    r = np.random.default_rng(seed)
    cfg = batch.BatchConfig(lanes=L, stack_slots=4, memory_bytes=32, calldata_bytes=32, storage_slots=2,
                            code_len=64, tape_slots=T, path_slots=P, mem_sym_slots=2, ss_ring=4)
    hs = r.integers(0, 2**32, (10, 2), dtype=np.uint64).astype(np.uint32)
    pick = r.integers(0, 10, (L, T))
    status = r.choice([0, 0, 5], L) if case == "not_running" else np.zeros(L, np.int64)
    plen_hi = P + 6 if case == "path_len_above" else P + 1
    id_lo = -3 if case == "ids_nonpositive" else 0
    st = batch.empty_batch(cfg, device="cpu")._replace(
        alive=torch.as_tensor(r.random(L) < (0.6 if case == "not_running" else 0.95)),
        status=torch.as_tensor(status.astype(np.int32)),
        path_len=torch.as_tensor(r.integers(0, plen_hi, L).astype(np.int32)),
        path_id=torch.as_tensor(r.integers(id_lo, 4 * T, (L, P)).astype(np.int32)),
        path_sign=torch.as_tensor(r.random((L, P)) < 0.5),
        tape_op=torch.as_tensor(np.where(r.random((L, T)) < 0.05, 32, 10).astype(np.int32)),
        tape_a=torch.as_tensor(r.integers(-1, T + 1, (L, T)).astype(np.int32)),
        tape_h1=torch.as_tensor(hs[pick, 0].view(np.int32)), tape_h2=torch.as_tensor(hs[pick, 1].view(np.int32)),
    )
    if case == "empty_pool":
        return st, inloop_solve.empty_pool("cpu")
    vsel = r.integers(0, 10, V)
    lo, hi = (-V - 3, V + 3) if case == "lit_var_range" else (0, V)
    pool = dict(var_h1=hs[vsel, 0], var_h2=hs[vsel, 1], lit_var=r.integers(lo, hi, (C, W)).astype(np.int32),
                lit_neg=r.random((C, W)) < 0.5, lit_used=(r.random((C, W)) < 0.2) | (np.arange(W) < 2))
    if case == "chain":
        # x0 -> x1 -> ... -> x5 and (not x5), one clause each, in thread
        # order: two sweeps from a path that asserts x0 reach x2 and x4 and
        # no conflict; a sweep that read its own forced values would
        # (ascending threads) reach x5 and conflict
        pool["var_h1"][1:6] = pool["var_h2"][1:6] = 0xDEAD0000 + np.arange(1, 6, dtype=np.uint32)
        pool["lit_used"][:] = False
        for c in range(5):
            pool["lit_var"][c, :2] = (c, c + 1)
            pool["lit_neg"][c, :2] = (True, False)
            pool["lit_used"][c, :2] = True
        pool["lit_var"][5, 0], pool["lit_neg"][5, 0], pool["lit_used"][5, 0] = 5, True, True
    return st, convert.pool_to_torch(pool, "cpu")


K3_CASES = {
    "v64": dict(V=64),
    "v256": dict(V=256, C=64),
    "empty_pool": dict(case="empty_pool"),
    "lit_var_range": dict(case="lit_var_range"),
    "path_len_above": dict(case="path_len_above"),
    "ids_nonpositive": dict(case="ids_nonpositive"),
    "not_running": dict(case="not_running"),
    "pn_above_warp": dict(P=40, T=48),
    "chain": dict(case="chain"),
}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_unsat_warp_logic_cases(emu, case):
    """K3 as one warp a lane, against the twin, with the warp's threads in
    ascending and descending order: pools at V = 64 and 256 and the empty
    pool, literals naming vars out of range either way, path lengths above
    Pn, ids <= 0, lanes not alive or not RUNNING, and more entries than a
    warp has threads."""
    st, pool = _pool_state(11, **K3_CASES[case])
    want = inloop_solve.unsat_mask_plain(pool, st)
    for reverse in (0, 1):
        got = _emu_unsat(emu, st, pool, reverse)
        assert torch.equal(got, want), (case, reverse, (got != want).nonzero().flatten().tolist())
    assert want.any() and not want.all()
    eligible = st.alive & (st.status == 0)
    assert not (want & ~eligible).any()


def _tagged_batch(seed, L=64):
    """Lanes with tagged rows (pc, steps, a stack word, visited bits) and
    random flags, for the epilogue cases."""
    r = np.random.default_rng(seed)
    cfg = batch.BatchConfig(lanes=L, stack_slots=4, memory_bytes=32, calldata_bytes=32, storage_slots=2,
                            code_len=64, tape_slots=8, path_slots=4, mem_sym_slots=2, ss_ring=4)
    st = batch.empty_batch(cfg, device="cpu")
    cb = batch.make_code_bank([assemble("STOP")], cfg.code_len, prune_revert=True, device="cpu")
    return r, cb, st._replace(
        pc=torch.arange(L, dtype=torch.int32) + 100,
        steps=torch.as_tensor(r.integers(0, 1000, L).astype(np.int32)),
        static_pruned=torch.as_tensor(r.integers(0, 9, L).astype(np.int32)),
        stack=torch.as_tensor(r.integers(-(1 << 31), 1 << 31, tuple(st.stack.shape), dtype=np.int64).astype(np.int32)),
        visited=torch.as_tensor(r.random(tuple(st.visited.shape)) < 0.2),
        outermost=torch.ones(L, dtype=torch.bool),
    )


def _epilogue_case(case, seed=3):
    """(cb, batch, unsat, n_shards) for one K4 case."""
    r, cb, st = _tagged_batch(seed)
    L = st.pc.shape[0]
    n = {"n2": 2, "n8": 8}.get(case, 1)
    alive = torch.as_tensor(r.random(L) < 0.6)
    status = torch.as_tensor(r.choice([0, 0, 1, 3, 5], L).astype(np.int32))
    trap_op = torch.as_tensor(r.choice([0xFD, 0x57], L).astype(np.int32))
    unsat = torch.as_tensor(r.random(L) < 0.2)
    if case == "identity":  # every shard's survivors are its prefix, nothing dies
        alive = torch.arange(L) < 40
        status = torch.zeros(L, dtype=torch.int32)
        unsat = torch.zeros(L, dtype=torch.bool)
    elif case == "all_move":  # lane 0 free, the rest survive: every lane moves
        alive = torch.arange(L) > 0
        status = torch.zeros(L, dtype=torch.int32)
        unsat = torch.zeros(L, dtype=torch.bool)
    elif case == "dying_in_place":  # lanes 0-29 survive, 30 reverts, 31 is killed, the rest are free
        alive = torch.arange(L) < 32
        status = torch.zeros(L, dtype=torch.int32)
        status[30] = batch.REVERTED
        unsat = torch.zeros(L, dtype=torch.bool)
        unsat[31] = True
    elif case == "steps_wrap":  # the dying lanes' steps sum past 2^31
        steps = torch.as_tensor(r.integers((1 << 31) - 5000, (1 << 31) - 1, L).astype(np.int32))
        st = st._replace(steps=steps, static_pruned=steps.flip(0))
    st = st._replace(alive=alive, status=status, trap_op=trap_op)
    return cb, st, unsat & alive, n


K4_CASES = ["n1", "n2", "n8", "identity", "all_move", "dying_in_place", "steps_wrap"]


@pytest.mark.parametrize("launch", [(1, 32), (4, 64), (25, 256)], ids=["1x32", "4x64", "25x256"])
@pytest.mark.parametrize("case", K4_CASES)
def test_epilogue_launch_logic_cases(emu, case, launch):
    """K4 as one cooperative launch, against the twin in both thread
    orders, with one warp for all rows, one for several and three warps a
    row: 1, 2 and 8 shards; an order where nothing moves; one where every
    lane moves; dying lanes that keep their place (they must be zeroed
    there); u32 folds that wrap past 2^31."""
    cb, st, unsat, n = _epilogue_case(case)
    L = st.pc.shape[0]
    acc0 = torch.tensor([5, (1 << 31) - 7, -3, 1], dtype=torch.int32)
    acc_t = acc0.clone()
    pv_t = torch.zeros(cb.code.shape, dtype=torch.bool)
    want = megakernel.round_epilogue_plain(cb, st, unsat, acc_t, pv_t, n)
    dying_t = (megakernel.prune_mask(cb, st) | unsat)
    survives = (st.alive & ~dying_t).to(torch.int32).view(n, -1)
    order_t = (torch.argsort(survives, dim=1, descending=True, stable=True)
               + torch.arange(0, L, L // n)[:, None]).reshape(L).to(torch.int32)
    moved = int((order_t != torch.arange(L)).sum())
    assert moved == {"identity": 0, "all_move": L}.get(case, moved)
    if case == "dying_in_place":
        assert order_t[30] == 30 and order_t[31] == 31 and bool(dying_t[30]) and bool(dying_t[31])
    if case == "steps_wrap":
        assert int(acc_t[1]) < int(acc0[1])  # wrapped
    for reverse in (0, 1):
        s = batch.StateBatch(*(x.clone() for x in st))
        scratch = batch.StateBatch(*(torch.empty_like(x) for x in s))
        acc, pv = acc0.clone(), torch.zeros_like(pv_t)
        ctl = torch.tensor([2, 1, 0, 0], dtype=torch.int32)
        sc = _emu_epilogue(emu, cb, s, scratch, unsat, acc, pv, ctl, 16, n, nblocks=launch[0],
                           nthreads=launch[1], reverse=reverse)
        _assert_same(s, want, f"{case} reverse={reverse}")
        assert torch.equal(acc, acc_t) and torch.equal(pv, pv_t)
        assert torch.equal(sc.order, order_t) and torch.equal(sc.dying.bool(), dying_t)
        assert ctl.tolist() == [3, int((want.alive & (want.status == 0)).any())] * 2


@pytest.mark.parametrize("gate", [0, 1])
def test_epilogue_compact_only_logic(emu, gate):
    """K4's bare compaction after a steal: with the gate open a stable
    per-shard compaction and nothing else (no prune of REVERTED lanes, no
    folds, no staging); with it shut nothing moves. The staged control
    word is committed either way."""
    cb, st, unsat, _n = _epilogue_case("n8")
    st = st._replace(status=torch.full_like(st.status, batch.REVERTED))
    for reverse in (0, 1):
        s = batch.StateBatch(*(x.clone() for x in st))
        scratch = batch.StateBatch(*(torch.empty_like(x) for x in s))
        acc, pv = torch.zeros(4, dtype=torch.int32), torch.zeros(cb.code.shape, dtype=torch.bool)
        ctl = torch.tensor([4, 1, 5, 0], dtype=torch.int32)
        _emu_epilogue(emu, cb, s, scratch, unsat, acc, pv, ctl, 16, 8,
                      kernels.EPI_COMMIT | kernels.EPI_COMPACT_ONLY, torch.tensor([gate], dtype=torch.int32),
                      reverse=reverse)
        _assert_same(s, megakernel.compact_plain(st, 8) if gate else st, f"gate={gate} reverse={reverse}")
        assert not acc.any() and not pv.any()
        assert ctl.tolist() == [5, 0, 5, 0]


@pytest.mark.parametrize("which", ["unsat", "epilogue"])
def test_prebuilt_args_refuse_other_tensors(which):
    """A loop's prebuilt launch arguments stand for the tensors they were
    built from: a launch that names others raises before any kernel runs.
    The structs need a card; the check itself does not."""
    t = [torch.zeros(4, dtype=torch.int32) for _ in range(8)]
    if which == "unsat":
        a = object.__new__(kernels.UnsatArgs)
        a.keep, a.out = (t[0], t[1], t[2]), t[3]
        a.check(t[0], t[1], t[2], None)
        a.check(t[0], t[1], t[2], t[3])
        bad = [(t[0], t[4], t[2], None), (t[0], t[1], None, None), (t[0], t[1], t[2], t[4])]
    else:
        a = object.__new__(kernels.EpilogueArgs)
        a.keep, a.shape = tuple(t[:7]), (16, 2)
        a.check(*t[:6], 16, t[6], 2)
        bad = [(*t[:6], 16, t[6], 1), (*t[:6], 8, t[6], 2), (t[0], t[7], *t[2:6], 16, t[6], 2)]
    for args in bad:
        with pytest.raises(_build.KernelError):
            a.check(*args)


# ---- K1's stats instance: the histogram folded inside the launch ------------


def _twin_steps_hist(cb, st, n_steps, hist0=None):
    """``n_steps`` twin steps, each followed by op_hist_update_plain, as
    the reference's loops fold them. Returns the batch, the histogram and
    how many fork children were binned from their lane's stale row."""
    hist = torch.zeros(256, dtype=torch.int32) if hist0 is None else hist0.clone()
    stale = 0
    for _ in range(n_steps):
        nst = engine.step_plain(cb, st)
        stale += int((~st.alive & nst.alive & (nst.steps > st.steps)).sum())
        hist = engine.op_hist_update_plain(cb, st, nst, hist)
        st = nst
    return st, hist, stale


_TWIN_HIST = {}


@pytest.mark.parametrize("order", ["ascending", "reversed"])
@pytest.mark.parametrize("nthreads", [32, 64, 128])
@pytest.mark.parametrize("name", ["stress", "bectoken"])
def test_step_run_hist_matches_twin(emu, name, nthreads, order):
    """One emulated launch of K1's stats instance, 64 steps of a forking
    batch, against 64 twin steps each followed by op_hist_update_plain:
    every plane and the histogram equal, with blocks of 32, 64 and 128
    threads and the lanes taken in ascending and reversed order."""
    cb, st = _inputs(name, 5)
    if name not in _TWIN_HIST:
        _TWIN_HIST[name] = _twin_steps_hist(cb, st, 64)
    want, want_hist, stale = _TWIN_HIST[name]
    assert int(want.alive.sum()) > int(st.alive.sum()) and stale > 0  # children binned from stale rows
    lanes = list(range(st.pc.shape[0]))
    hist = torch.zeros(256, dtype=torch.int32)
    got = _emu_k1(emu, cb, st, 64, nthreads=nthreads, order=lanes[::-1] if order == "reversed" else None,
                  hist=hist)
    _assert_same(got, want, f"{name} nthreads={nthreads} {order}")
    assert torch.equal(hist, want_hist)


def test_step_run_hist_bins_children_from_stale_rows(emu):
    """A step in which parents fork into free lanes whose stale rows hold
    distinct opcodes at their pc and steps below and above (and, with a
    third child, equal to) the parent's post-step steps: each child lands in the bin of its lane's
    own stale row, and only where the parent's steps exceed the row's, as
    the reference's whole-batch compare has it. A child binned from its
    parent (JUMPI, always counted) would show in the histogram."""
    cb, st = _inputs("stress", 5)
    for _ in range(60):
        nxt = engine.step_plain(cb, st)
        children = (~st.alive & nxt.alive).nonzero().flatten().tolist()
        if len(children) >= 2:
            break
        st = nxt
    assert len(children) >= 2
    code = cb.code[0].tolist()
    code_len = int(cb.code_len[0])
    first_at = {}
    for pc in range(code_len):
        if code[pc] != 0x57:
            first_at.setdefault(code[pc], pc)
    free = (~st.alive).nonzero().flatten().tolist()
    assert len(first_at) >= len(free)
    pcs = st.pc.clone()
    steps = st.steps.clone()
    for i, lane in enumerate(free):
        pcs[lane] = list(first_at.values())[i]
        steps[lane] = 1000 + 7 * i
    for i, lane in enumerate(children):
        steps[lane] = int(nxt.steps[lane]) + (-1 - i, 5 + i, 0)[i % 3]
    st = st._replace(pc=pcs, steps=steps)
    nxt = engine.step_plain(cb, st)
    assert (~st.alive & nxt.alive).nonzero().flatten().tolist() == children
    counted = nxt.steps[children] > st.steps[children]
    assert counted.any() and (~counted).any()
    want_hist = engine.op_hist_update_plain(cb, st, nxt, torch.zeros(256, dtype=torch.int32))
    for lane in torch.as_tensor(children)[counted].tolist():
        assert int(want_hist[code[int(st.pc[lane])]]) >= 1
    for n_steps in (1, 3):
        want, want_hist, _ = _twin_steps_hist(cb, st, n_steps)
        for order in (None, list(range(st.pc.shape[0]))[::-1]):
            hist = torch.zeros(256, dtype=torch.int32)
            got = _emu_k1(emu, cb, st, n_steps, order=order, hist=hist)
            _assert_same(got, want, f"stale rows, {n_steps} steps, order {order}")
            assert torch.equal(hist, want_hist), (hist - want_hist).nonzero().flatten().tolist()


@pytest.mark.parametrize("case", ["ctl_stopped", "wraps"])
def test_step_run_hist_edge_cases(emu, case):
    """A launch that the loop's control word stops adds nothing and steps
    nothing; a histogram seeded near 2^32 wraps mod 2^32, as the twin's
    u32 bins do."""
    cb, st = _inputs("bectoken", 5)
    r = np.random.default_rng(8)
    if case == "ctl_stopped":
        hist0 = torch.as_tensor(r.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32).view(np.int32))
        hist = hist0.clone()
        got = _emu_k1(emu, cb, st, 64, ctl=torch.tensor([3, 0, 0, 0], dtype=torch.int32), hist=hist)
        _assert_same(got, st, "stopped")
        assert torch.equal(hist, hist0)
        return
    hist0 = torch.full((256,), -3, dtype=torch.int32)  # 2^32 - 3 in every bin
    want, want_hist, _ = _twin_steps_hist(cb, st, 64, hist0)
    hist = hist0.clone()
    got = _emu_k1(emu, cb, st, 64, ctl=torch.tensor([0, 1, 0, 0], dtype=torch.int32), hist=hist)
    _assert_same(got, want, "wraps")
    assert torch.equal(hist, want_hist)
    wrapped = (hist.to(torch.int64) & engine.M32) < (hist0.to(torch.int64) & engine.M32)
    assert wrapped.any() and (hist >= 0).any()


@pytest.mark.parametrize("name", ["stress", "short"])
def test_step_n_hist_on_cpu_matches_run_plain(name):
    """``engine.step_n(..., hist=)`` on CPU tensors, the twin's form of K1's
    stats instance: max_steps steps with the histogram added in place
    equal ``run_plain``'s slice, which stops once no lane runs."""
    cb, st = _short_inputs() if name == "short" else _inputs(name, 3)
    want, want_hist = engine.run_plain(cb, st, 40, True)
    hist = torch.zeros(256, dtype=torch.int32)
    got = engine.step_n(cb, None, st, 40, device="cpu", hist=hist)
    _assert_same(got, want, name)
    assert torch.equal(hist, want_hist) and int(hist.sum()) > 0
