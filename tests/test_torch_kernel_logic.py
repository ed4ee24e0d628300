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


def _emu_k1(lib, cb, st, n_steps, n_shards=1, order=None, nthreads=128, ctl=None):
    """One emulated K1 launch of ``n_steps`` steps on a copy of ``st``."""
    st = batch.StateBatch(*(x.clone() for x in st))
    sc = kernels.Scratch.get(torch.device("cpu"), st.pc.shape[0])
    pl = kernels.planes(st, cb.code.shape[0], cb.code.shape[1])
    bk = kernels.bank(cb)
    order = None if order is None else torch.as_tensor(order, dtype=torch.int32)
    rc = lib.emu_step_run(ctypes.byref(pl), ctypes.byref(bk), _vp(sc.tab), _vp(sc.flags),
                          _vp(ctl) if ctl is not None else None, n_shards, n_steps, nthreads,
                          _vp(order) if order is not None else None)
    assert rc == 0
    return st


def _emu_step(lib, cb, st):
    return _emu_k1(lib, cb, st, 1)


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
    out = torch.zeros(L, dtype=torch.bool)
    pl = kernels.planes(st, 1, 64)
    ps = kernels.pool_struct(pool)
    assert emu.emu_unsat(ctypes.byref(pl), ctypes.byref(ps), _vp(out)) == 0
    want = inloop_solve.unsat_mask_plain(pool, st)
    assert torch.equal(out, want)
    assert want.any() and not want.all()


def _emu_hist(lib, cb, snap, s, hist, ctl, refresh=True):
    n_codes, CL = cb.code.shape
    assert lib.emu_op_hist(_vp(cb.code), n_codes, CL, _vp(snap.code_id), _vp(snap.pc), _vp(snap.steps),
                           _vp(s.code_id), _vp(s.pc), _vp(s.steps), s.steps.shape[0], _vp(hist),
                           _vp(ctl) if ctl is not None else None, int(refresh)) == 0


def _emu_fused(lib, cb, st, max_rounds, steps_per_round, with_solve, pool, with_stats=False):
    """run_fused's card loop, with the emulated kernels."""
    L = st.pc.shape[0]
    s = batch.StateBatch(*(x.clone() for x in st))
    hist = torch.zeros(256, dtype=torch.int32)
    scratch = batch.StateBatch(*(torch.empty_like(x) for x in s))
    ctl = torch.zeros(4, dtype=torch.int32)
    ctl[1] = int(bool((s.alive & (s.status == 0)).any()) and max_rounds > 0)
    acc = torch.zeros(4, dtype=torch.int32)
    pv = torch.zeros(cb.code.shape, dtype=torch.bool)
    sc = kernels.Scratch.get(torch.device("cpu"), L)
    for _ in range(max_rounds):
        snap = engine.snapshot(s)
        if with_stats:  # one K1 launch and one K8 launch per step
            for _ in range(steps_per_round):
                for x, y in zip(s, _emu_k1(lib, cb, s, 1, ctl=ctl)):
                    x.copy_(y)
                _emu_hist(lib, cb, snap, s, hist, ctl)
        else:  # the round in one K1 launch
            for x, y in zip(s, _emu_k1(lib, cb, s, steps_per_round, ctl=ctl)):
                x.copy_(y)
        unsat = torch.zeros(L, dtype=torch.bool)
        if with_solve and ctl[1]:
            pl = kernels.planes(s, 1, cb.code.shape[1])
            assert lib.emu_unsat(ctypes.byref(pl), ctypes.byref(kernels.pool_struct(pool)), _vp(unsat)) == 0
        pl = kernels.planes(s, cb.code.shape[0], cb.code.shape[1])
        psc = kernels.planes(scratch, cb.code.shape[0], cb.code.shape[1])
        assert lib.emu_epilogue(ctypes.byref(pl), ctypes.byref(psc), _vp(cb.prune_revert), _vp(unsat), _vp(acc),
                                _vp(sc.order), _vp(sc.dying), _vp(pv), _vp(ctl), max_rounds) == 0
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
    if with_solve:  # stats on: K8 inside the rounds
        assert torch.equal(hist, want.hist) and int(hist.sum()) > 0


def test_op_hist_logic_matches_twin(emu):
    """K8's lane logic on code ids, pcs and step counters out of range,
    and its snapshot refresh."""
    r = np.random.default_rng(6)
    L = 96
    code = torch.as_tensor(r.integers(0, 256, (3, 64), dtype=np.uint8))
    cb = batch.CodeBank(*([None] * len(batch.CodeBank._fields)))._replace(code=code)
    snap = engine.Snapshot(torch.as_tensor(r.choice([-7, -4, -1, 0, 2, 3, 1 << 30], L).astype(np.int32)),
                           torch.as_tensor(r.choice([-(1 << 31), -1, 0, 63, 64, 900], L).astype(np.int32)),
                           torch.as_tensor(r.choice([-(1 << 31), -1, 0, 7, (1 << 31) - 1], L).astype(np.int32)))
    after = engine.Snapshot(*(torch.as_tensor(r.integers(-5, 70, L).astype(np.int32)) for _ in range(2)),
                            (snap.steps.to(torch.int64) + torch.as_tensor(r.integers(-1, 2, L))).to(torch.int32))
    hist0 = torch.as_tensor(r.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32).view(np.int32))
    want = engine.op_hist_update_plain(cb, snap, after, hist0)
    hist = hist0.clone()
    _emu_hist(emu, cb, snap, after, hist, torch.tensor([0, 1, 0, 0], dtype=torch.int32))
    assert torch.equal(hist, want) and not torch.equal(hist, hist0)
    assert all(torch.equal(x, y) for x, y in zip(snap, after))  # refreshed
    stopped = hist.clone()
    _emu_hist(emu, cb, snap, after, stopped, torch.tensor([0, 0, 0, 0], dtype=torch.int32))
    assert torch.equal(stopped, hist)  # a stopped loop's K8 adds nothing


def _emu_run(lib, cb, st, max_steps, with_stats):
    """engine.run_with_stats's card loop, with the emulated kernels: K9
    before each step, the step and K8 behind the control word."""
    s = batch.StateBatch(*(x.clone() for x in st))
    ctl = torch.zeros(4, dtype=torch.int32)
    hist = torch.zeros(256 if with_stats else 1, dtype=torch.int32)
    snap = engine.snapshot(s)
    for _ in range(max_steps):
        assert lib.emu_slice_ctl(_vp(s.alive), _vp(s.status), s.alive.shape[0], _vp(ctl), max_steps) == 0
        for x, y in zip(s, _emu_k1(lib, cb, s, 1, ctl=ctl)):
            x.copy_(y)
        if with_stats:
            _emu_hist(lib, cb, snap, s, hist, ctl)
    return s, hist, ctl


@pytest.mark.parametrize("name", [*sorted(SOURCES), "short"])
def test_slice_loop_logic_matches_twin(emu, name):
    if name == "short":  # every lane halts before max_steps
        cb = batch.make_code_bank([assemble("PUSH1 0x01\nPUSH1 0x02\nADD\nSTOP")], CFG.code_len, host_ops=HOST_OPS,
                                  freeze_errors=True, device="cpu")
        st = _inputs("stress", 3)[1]
    else:
        cb, st = _inputs(name, 3)
    for with_stats in (True, False):
        want, want_hist = engine.run_plain(cb, st, 40, with_stats)
        s, hist, ctl = _emu_run(emu, cb, st, 40, with_stats)
        _assert_same(s, want, f"{name} slice")
        assert torch.equal(hist, want_hist)
        # K9's twin commits the same control word
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
    """Alive, REVERT-pruned and in-loop-killed lanes in one round."""
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
    s = batch.StateBatch(*(x.clone() for x in st))
    scratch = batch.StateBatch(*(torch.empty_like(x) for x in s))
    acc = torch.zeros(4, dtype=torch.int32)
    pv = torch.zeros_like(pv_t)
    ctl = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    sc = kernels.Scratch.get(torch.device("cpu"), L)
    pl = kernels.planes(s, 1, CFG.code_len)
    psc = kernels.planes(scratch, 1, CFG.code_len)
    assert emu.emu_epilogue(ctypes.byref(pl), ctypes.byref(psc), _vp(cb.prune_revert), _vp(unsat), _vp(acc),
                            _vp(sc.order), _vp(sc.dying), _vp(pv), _vp(ctl), 16) == 0
    _assert_same(s, want, "epilogue")
    assert torch.equal(acc, acc_t) and torch.equal(pv, pv_t)
    assert int(acc[0]) > 0 and int(acc[3]) > 0  # both prune and kill happened
    assert ctl[:2].tolist() == [1, int((want.alive & (want.status == 0)).any())]
