"""The mesh kernels' own logic against the plain twins, on the CPU.

The steal kernel (K10's counts and plan and K11's moves, one kernel),
K12 (``mesh_deal``) and the shard count of K1's fork rank and K4's
compaction are plain C++ over pointers in
``mythril_tpu_torch/csrc/{mesh,step,megakernel}.cuh``; compiled as host
C++ (``csrc/host_emu.cpp``), they run here on CPU tensors and are held
bit for bit against the twins, which test_torch_mesh.py and
test_torch_mesh_fused.py hold against the JAX reference. The steal
kernel and K12 run as their launches do, each part thread by thread
between the barriers, in both thread orders and on several grids. The emulated fused
mesh loop follows ``run_fused_mesh``'s card loop launch for launch,
control word and steal gate included. On the card, chip_smoke.py does
the same with the real kernels."""

import ctypes
import os

import numpy as np
import pytest
import torch

import bench
from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.laser.cuda import _build, batch, engine, inloop_solve, kernels, megakernel, mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = batch.BatchConfig(lanes=16, stack_slots=32, memory_bytes=256, calldata_bytes=128, storage_slots=8,
                        code_len=512, tape_slots=64, path_slots=16, mem_sym_slots=8, ss_ring=16)
HOST_OPS = (0x00, 0xF3, 0xFD, 0xFF, 0xFE)
SYM = dict(symbolic_calldata=True, symbolic_storage=True, symbolic_caller=True, symbolic_callvalue=True)
SOURCES = {
    "stress": bench.STRESS_SRC,
    "bectoken": open(os.path.join(ROOT, "bench_contracts", "bectoken.asm")).read(),
}
# seeds in lanes 0, 2, 4, 6: a free lane in each of shards 0-3 (of 8)
SPREAD = torch.tensor([0, 8, 1, 9, 2, 10, 3, 11, 4, 12, 5, 13, 6, 14, 7, 15])


@pytest.fixture(scope="module")
def emu():
    return _build.host_emulation()


def _vp(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _clone(st):
    return batch.StateBatch(*(x.clone() for x in st))


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
    st = batch.build_batch(CFG, [dict(SYM), dict(SYM)] + conc, device="cpu")
    return cb, batch.StateBatch(*(x[SPREAD] for x in st))


def _emu_k1(lib, cb, st, n, n_steps, ctl=None, nthreads=128, hist=None):
    """One emulated K1 launch of ``n_steps`` steps over ``n`` lane blocks;
    with ``hist`` (added into in place) its stats instance."""
    st = _clone(st)
    sc = kernels.Scratch.get(torch.device("cpu"), st.pc.shape[0])
    pl = kernels.planes(st, cb.code.shape[0], cb.code.shape[1])
    bk = kernels.bank(cb)
    rc = lib.emu_step_run(ctypes.byref(pl), ctypes.byref(bk), _vp(sc.tab), _vp(sc.flags), _vp(ctl),
                          _vp(hist) if hist is not None else None, _vp(sc.hrec) if hist is not None else None,
                          n, n_steps, nthreads, None)
    assert rc == 0
    return st


def _emu_step(lib, cb, st, n):
    return _emu_k1(lib, cb, st, n, 1)


def _emu_epilogue(lib, cb, s, scratch, unsat, acc, pv, ctl, max_rounds, n, flags, gate=None, reverse=0):
    """One emulated K4 launch (2 blocks of 64 threads, each part's
    threads in ascending or descending order) on ``s`` in place."""
    sc = kernels.Scratch.get(torch.device("cpu"), s.pc.shape[0])
    pl = kernels.planes(s, cb.code.shape[0], cb.code.shape[1])
    psc = kernels.planes(scratch, cb.code.shape[0], cb.code.shape[1])
    assert lib.emu_epilogue(ctypes.byref(pl), ctypes.byref(psc), _vp(cb.prune_revert), _vp(unsat), _vp(acc),
                            _vp(sc.order), _vp(sc.dying), _vp(sc.eflags), _vp(pv), _vp(ctl), max_rounds, n, flags,
                            _vp(gate), 2, 64, reverse) == 0


def _emu_steal(lib, st, n, flags, plan=None, mctl=None, ctl=None, nblocks=1, nthreads=None, reverse=0):
    """One emulated launch of the steal kernel on ``st`` in place, its
    outputs pre-filled with a pattern (or ``plan``'s export, buf_pos and
    alive_c, for the moves of a given plan). Returns (export, buf_pos,
    sh, mctl)."""
    L = st.pc.shape[0]
    export = torch.full((L,), 0xA5, dtype=torch.uint8)
    buf_pos = torch.full((L,), -7, dtype=torch.int32)
    sh = torch.full((3 * n,), -9, dtype=torch.int32)
    if plan is not None:
        export.copy_(plan.export.to(torch.uint8))
        buf_pos.copy_(plan.buf_pos)
        sh[n:2 * n] = plan.alive_c
    mctl = torch.tensor([-3, -5, 11, 13], dtype=torch.int32) if mctl is None else mctl
    nthreads = nthreads or -(-L // 32) * 32
    pl = kernels.planes(st, 1, st.visited.shape[1])
    assert lib.emu_mesh_steal(ctypes.byref(pl), n, flags, _vp(export), _vp(buf_pos), _vp(sh), _vp(mctl), _vp(ctl),
                              nblocks, nthreads, reverse) == 0
    return export, buf_pos, sh, mctl


def _random_batch(seed, L=64, dense=True, n=8):
    """Lanes with random alive/RUNNING flags and tagged rows; with
    ``dense`` the alive lanes of each of the ``n`` shards form a prefix."""
    r = np.random.default_rng(seed)
    cfg = batch.BatchConfig(lanes=L, stack_slots=4, memory_bytes=32, calldata_bytes=32, storage_slots=2,
                            code_len=64, tape_slots=8, path_slots=4, mem_sym_slots=2, ss_ring=4)
    st = batch.empty_batch(cfg, device="cpu")
    per = L // n
    alive = np.zeros(L, bool)
    if dense:
        for s in range(n):
            alive[s * per: s * per + int(r.choice([0, 0, 1, 2, per, per - 1, 3]))] = True
    else:
        alive = r.random(L) < 0.4
    status = np.where(r.random(L) < 0.7, batch.RUNNING, batch.STOPPED).astype(np.int32)
    return st._replace(
        alive=torch.as_tensor(alive), status=torch.as_tensor(status),
        pc=torch.arange(L, dtype=torch.int32) + 100,
        steps=torch.as_tensor(r.integers(0, 1000, L).astype(np.int32)),
        static_pruned=torch.as_tensor(r.integers(0, 9, L).astype(np.int32)),
        stack=torch.as_tensor(r.integers(-(1 << 31), 1 << 31, tuple(st.stack.shape), dtype=np.int64).astype(np.int32)),
        visited=torch.as_tensor(r.random(tuple(st.visited.shape)) < 0.2),
    )


def _shaped_batch(kind, L, n, seed):
    """A tagged batch of ``L`` lanes over ``n`` shards: ``ragged`` (each
    shard a dense prefix of random length), ``sparse`` (alive anywhere),
    ``skew`` (shards 0-1 full of running lanes, the rest empty: the skew
    demos' steal), ``idle`` (no lane running), ``all_running``, or
    ``full_receivers`` (shard 0 running, every other lane alive and
    halted: the deficit is capped to 0, so nothing moves whatever the
    spread)."""
    st = _random_batch(seed, L, dense=kind != "sparse", n=n)
    per = L // n
    lane = torch.arange(L)
    if kind == "skew":
        alive = lane < 2 * per
        status = torch.full((L,), batch.RUNNING, dtype=torch.int32)
    elif kind == "idle":
        alive, status = st.alive, torch.full((L,), batch.STOPPED, dtype=torch.int32)
    elif kind == "all_running":
        alive, status = torch.ones(L, dtype=torch.bool), torch.full((L,), batch.RUNNING, dtype=torch.int32)
    elif kind == "full_receivers":
        alive = torch.ones(L, dtype=torch.bool)
        status = torch.where(lane < per, batch.RUNNING, batch.STOPPED).to(torch.int32)
    else:
        return st
    return st._replace(alive=alive, status=status)


# the emulated grids: (blocks, threads a block; None: the lanes rounded up to a warp)
GRIDS = ((1, 1024), (3, None), (2, 1024), (1, None))
SHAPES = [(L, n) for L in (64, 160, 512, 1024) for n in (1, 2, 8, 64) if L % n == 0]


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_sharded_step_logic_matches_twin(emu, name, n):
    cb, st = _inputs(name, 5)
    se = st
    for i in range(60):
        st = engine.step_plain(cb, st, n)
        se = _emu_step(emu, cb, se, n)
        _assert_same(se, st, f"{name} n={n} step {i}")
    assert int(st.alive.sum()) > 4


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_sharded_step_run_launch_matches_twin(emu, name):
    """One emulated K1 launch of 64 steps over 8 lane blocks against 64
    twin steps with the same shard count, with blocks of 128 and 32
    threads: forks land inside their own block or trap (SLOT_FULL)."""
    cb, st = _inputs(name, 5)
    want = st
    for _ in range(64):
        want = engine.step_plain(cb, want, 8)
    assert int(want.alive.sum()) > int(st.alive.sum())
    for nthreads in (128, 32):
        got = _emu_k1(emu, cb, st, 8, 64, nthreads=nthreads)
        _assert_same(got, want, f"{name} n=8 nthreads={nthreads}")


def _check_steal_uses(emu, st, n, where):
    """Every use of the steal kernel on ``st`` against the twins, on each
    emulated grid in both thread orders: counts, plan, the moves of the
    twin's plan, the fused steal round from nonzero counters, and a
    fused launch of a stopped loop (which writes nothing)."""
    plan = mesh.steal_plan_plain(st, n)
    moved = int(plan.moved)
    go = int(moved > 0 and int(plan.occ.max()) - int(plan.occ.min()) > 1)
    moved_st = mesh.steal_apply_plain(st, plan, n)
    untouched = (torch.full_like(plan.export, 0xA5, dtype=torch.uint8), torch.full_like(plan.buf_pos, -7))
    for nblocks, nthreads in GRIDS:
        for reverse in (0, 1):
            at = f"{where} grid={nblocks}x{nthreads} reverse={reverse}"
            kw = dict(nblocks=nblocks, nthreads=nthreads, reverse=reverse)
            s = _clone(st)
            export, buf_pos, sh, mctl = _emu_steal(emu, s, n, 0, **kw)
            assert torch.equal(sh[:2 * n], torch.cat([mesh.occupancy_impl_plain(st, n), plan.alive_c])), at
            assert (export.tolist(), buf_pos.tolist()) == tuple(t.tolist() for t in untouched), at
            assert (sh[2 * n:] == -9).all() and mctl.tolist() == [-3, -5, 11, 13], at
            _assert_same(s, st, f"{at} counts")
            export, buf_pos, sh, mctl = _emu_steal(emu, s, n, kernels.MESH_PLAN, **kw)
            assert torch.equal(export.bool(), plan.export) and torch.equal(buf_pos, plan.buf_pos), at
            assert torch.equal(sh, torch.cat([plan.occ, plan.alive_c, plan.filled])), at
            assert mctl.tolist() == [int(moved > 0), moved, 11, 13], at
            _assert_same(s, st, f"{at} plan")
            _emu_steal(emu, s, n, kernels.MESH_MOVE, plan=plan, **kw)
            _assert_same(s, moved_st, f"{at} moves of a given plan")
            s = _clone(st)
            export, buf_pos, sh, mctl = _emu_steal(emu, s, n, kernels.MESH_STEAL_ROUND, **kw)
            assert torch.equal(export.bool(), plan.export) and torch.equal(buf_pos, plan.buf_pos), at
            assert torch.equal(sh, torch.cat([plan.occ, plan.alive_c, plan.filled])), at
            assert mctl.tolist() == [go, moved, 11 + go, 13 + go * moved], at
            _assert_same(s, moved_st if go else st, f"{at} steal round")
            s = _clone(st)
            stopped = torch.tensor([3, 0, 4, 1], dtype=torch.int32)
            export, buf_pos, sh, mctl = _emu_steal(emu, s, n, kernels.MESH_STEAL_ROUND, ctl=stopped, **kw)
            assert (export.tolist(), buf_pos.tolist()) == tuple(t.tolist() for t in untouched), at
            assert (sh == -9).all() and mctl.tolist() == [-3, -5, 11, 13], at
            _assert_same(s, st, f"{at} stopped")
    return plan, go


@pytest.mark.parametrize("seed", range(6))
def test_mesh_plan_and_steal_logic_match_twin(emu, seed):
    st = _random_batch(seed, dense=seed % 3 != 2)
    _check_steal_uses(emu, st, 8, f"seed {seed}")


@pytest.mark.parametrize("kind", ["ragged", "sparse", "skew", "idle", "all_running", "full_receivers"])
@pytest.mark.parametrize("L,n", SHAPES, ids=[f"L{L}-n{n}" for L, n in SHAPES])
def test_steal_kernel_uses_match_twins(emu, L, n, kind):
    """Every use of the steal kernel at lane counts 64-1024 over 1-64
    shards, so that a shard's lanes are below a warp (per 1, 8, 16, 20),
    not a multiple of one (per 20, 80, 160) and whole warps, on each kind
    of batch."""
    st = _shaped_batch(kind, L, n, L + n)
    plan, go = _check_steal_uses(emu, st, n, f"{kind} L={L} n={n}")
    moved = int(plan.moved)
    if kind == "skew":  # shards 0-1 keep their fair share of the 2 * per running lanes
        per, base = L // n, 2 * L // n // n
        rem = 2 * per - base * n
        want = 2 * per - 2 * base - min(rem, 2) if n > 1 else 0
        assert moved == want and go == int(want > 0 and per - base > 1), (moved, go, plan.occ.tolist())
    if kind in ("idle", "all_running", "full_receivers") or n == 1:
        assert moved == 0 and not go
    if kind == "full_receivers" and n > 1 and L // n > 1:
        assert int(plan.occ.max()) - int(plan.occ.min()) > 1


def test_mesh_plan_gate_and_counters(emu):
    # [1, 1, 0, ...]: moved 0 -> no steal; a spread of 2 -> steal, counted
    for lanes, go in (([0, 8], 0), ([0, 1, 2, 8], 1)):
        st = _random_batch(0)
        alive = torch.zeros(64, dtype=torch.bool)
        alive[lanes] = True
        st = st._replace(alive=alive, status=torch.zeros(64, dtype=torch.int32))
        for reverse in (0, 1):
            mctl = torch.tensor([9, 9, 5, 7], dtype=torch.int32)
            s = _clone(st)
            _emu_steal(emu, s, 8, kernels.MESH_STEAL_ROUND, mctl=mctl, nblocks=2, reverse=reverse)
            moved = int(mesh.steal_plan_plain(st, 8).moved)
            assert mctl.tolist() == [go, moved, 5 + go, 7 + go * moved]
            assert torch.equal(s.alive, st.alive) == (not go)
    # a gated no-steal with moved > 0: shard 7's one extra lane against shard 0's fair share of one more
    st = _shaped_batch("ragged", 64, 8, 0)
    st = st._replace(alive=torch.arange(64) % 8 < 4 + (torch.arange(64) >= 56).to(torch.int64),
                     status=torch.zeros(64, dtype=torch.int32))
    plan = mesh.steal_plan_plain(st, 8)
    assert int(plan.moved) == 1 and int(plan.occ.max()) - int(plan.occ.min()) == 1
    mctl = torch.zeros(4, dtype=torch.int32)
    s = _clone(st)
    _emu_steal(emu, s, 8, kernels.MESH_STEAL_ROUND, mctl=mctl, nblocks=3)
    assert mctl.tolist() == [0, 1, 0, 0]
    _assert_same(s, st, "gated no-steal")
    # a stopped loop's launch touches nothing
    st = _random_batch(1)
    mctl = torch.zeros(4, dtype=torch.int32)
    _e, _b, sh, _ = _emu_steal(emu, st, 8, kernels.MESH_PLAN, ctl=torch.tensor([3, 0, 0, 0], dtype=torch.int32),
                               mctl=mctl)
    assert (sh == -9).all() and not mctl.any()


def _bytes(x):
    """A plane's bytes, a row a lane."""
    return x.reshape(x.shape[0], -1).view(torch.uint8)


def _emu_deal(lib, st, n, nblocks=1, nthreads=None, reverse=0):
    """One emulated K12 launch on ``st`` in place, through a scratch
    batch whose bytes are a pattern (0xA5) and into an order buffer of
    -7s. Returns (order, scratch)."""
    L = st.pc.shape[0]
    scratch = batch.StateBatch(*(torch.empty_like(x) for x in st))
    for x in scratch:
        _bytes(x).fill_(0xA5)
    order = torch.full((L,), -7, dtype=torch.int32)
    nthreads = nthreads or -(-L // 32) * 32
    pl = kernels.planes(st, 1, st.visited.shape[1])
    ps = kernels.planes(scratch, 1, st.visited.shape[1])
    assert lib.emu_mesh_deal(ctypes.byref(pl), ctypes.byref(ps), n, _vp(order), nblocks, nthreads, reverse) == 0
    return order, scratch


def _check_deal(emu, st, n, where):
    """K12 on ``st`` against the twins on each emulated grid in both
    thread orders: the order, every plane, and no scratch row written
    past the rows that move. Returns the number of rows that move."""
    L = st.pc.shape[0]
    order_t = mesh.deal_order_plain(st, n)
    want = batch.StateBatch(*(x[order_t] for x in st))
    if n >= 2:
        _assert_same(want, mesh.rebalance_plain(st, n), f"{where} twin")
    dealt = int((order_t != torch.arange(L)).sum())
    for nblocks, nthreads in GRIDS:
        for reverse in (0, 1):
            at = f"{where} grid={nblocks}x{nthreads} reverse={reverse}"
            s = _clone(st)
            order, scratch = _emu_deal(emu, s, n, nblocks, nthreads, reverse)
            assert torch.equal(order.long(), order_t), at
            _assert_same(s, want, at)
            for name, x in zip(batch.StateBatch._fields, scratch):
                assert (_bytes(x)[dealt:] == 0xA5).all(), f"{at}: scratch {name} written past row {dealt}"
    return dealt


@pytest.mark.parametrize("n", [8, 4, 2])
def test_mesh_deal_logic_matches_twin(emu, n):
    _check_deal(emu, _random_batch(n, dense=False), n, f"random n={n}")


@pytest.mark.parametrize("kind", ["ragged", "sparse", "skew", "idle", "all_running", "full_receivers"])
@pytest.mark.parametrize("L,n", SHAPES, ids=[f"L{L}-n{n}" for L, n in SHAPES])
def test_deal_kernel_matches_twins(emu, L, n, kind):
    """K12 at the steal kernel's lane counts and shard counts, on each
    kind of batch."""
    st = _shaped_batch(kind, L, n, L + n + 1)
    dealt = _check_deal(emu, st, n, f"{kind} L={L} n={n}")
    if n > 1 and L // n > 2:  # slot 1 takes packed place n: some lane always moves
        assert dealt > 0


@pytest.mark.parametrize("case", ["one_shard", "a_lane_a_shard", "two_lanes_a_shard"])
def test_deal_identity_writes_only_order(emu, case):
    """Deals where every lane keeps its slot: one shard with the running
    lanes first, a lane a shard with the running lanes first, and two
    lanes a shard with exactly each shard's first lane running. The
    launch writes the order and nothing else: every plane and every
    scratch byte keep theirs."""
    L = 64
    n, running = {"one_shard": (1, torch.arange(L) < 20), "a_lane_a_shard": (64, torch.arange(L) < 37),
                  "two_lanes_a_shard": (32, torch.arange(L) % 2 == 0)}[case]
    st = _random_batch(3, L, n=8)
    st = st._replace(alive=running | (torch.arange(L) % 3 == 0),
                     status=torch.where(running, batch.RUNNING, batch.STOPPED).to(torch.int32))
    assert torch.equal(mesh.deal_order_plain(st, n), torch.arange(L))
    for nblocks, nthreads in GRIDS:
        for reverse in (0, 1):
            s = _clone(st)
            order, scratch = _emu_deal(emu, s, n, nblocks, nthreads, reverse)
            assert torch.equal(order.long(), torch.arange(L))
            _assert_same(s, st, f"{case} grid={nblocks}x{nthreads}")
            assert all((_bytes(x) == 0xA5).all() for x in scratch)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_epilogue_logic_matches_twin(emu, n):
    cb, st = _inputs("stress", 2)
    for _ in range(30):
        st = engine.step_plain(cb, st, n)
    r = np.random.default_rng(n)
    L = CFG.lanes
    status = st.status.clone()
    status[torch.as_tensor(r.random(L)) < 0.2] = batch.REVERTED
    st = st._replace(status=status, alive=st.alive | torch.as_tensor(r.random(L) < 0.3),
                     steps=torch.as_tensor(r.integers(0, 100, L).astype(np.int32)))
    unsat = torch.as_tensor(r.random(L) < 0.3) & st.alive
    acc_t = torch.zeros(4, dtype=torch.int32)
    pv_t = torch.zeros(cb.code.shape, dtype=torch.bool)
    want = megakernel.round_epilogue_plain(cb, st, unsat, acc_t, pv_t, n)
    shuffled = batch.StateBatch(*(x[torch.as_tensor(r.permutation(L))] for x in want))
    for reverse in (0, 1):
        s = _clone(st)
        scratch = batch.StateBatch(*(torch.empty_like(x) for x in s))
        acc = torch.zeros(4, dtype=torch.int32)
        pv = torch.zeros_like(pv_t)
        ctl = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
        _emu_epilogue(emu, cb, s, scratch, unsat, acc, pv, ctl, 16, n, 0, reverse=reverse)
        _assert_same(s, want, f"epilogue n={n} reverse={reverse}")
        assert torch.equal(acc, acc_t) and torch.equal(pv, pv_t)
        # not committed yet: the mesh loop commits after the steal
        assert ctl.tolist() == [0, 1, 1, int((want.alive & (want.status == 0)).any())]
        # a bare compaction (gate open) leaves the counters alone
        s = _clone(shuffled)
        _emu_epilogue(emu, cb, s, scratch, unsat, acc, pv, ctl, 16, n,
                      kernels.EPI_COMMIT | kernels.EPI_COMPACT_ONLY, torch.ones(1, dtype=torch.int32), reverse)
        _assert_same(s, megakernel.compact_plain(shuffled, n), f"compaction n={n} reverse={reverse}")
        assert torch.equal(acc, acc_t) and torch.equal(pv, pv_t)
        assert ctl[:2].tolist() == ctl[2:].tolist()


@pytest.mark.parametrize("gate", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_compaction_logic_gate(emu, n, gate):
    """The bare compaction after a steal (EPI_COMPACT_ONLY) on tagged
    rows with REVERTED and killed-looking lanes: with the gate open a
    stable compaction per shard and no prune, kill, fold or staging; shut,
    no row moves. Either way the staged control word is committed."""
    st = _random_batch(10 + n, dense=False)
    st = st._replace(status=torch.where(st.status == batch.STOPPED, batch.REVERTED, st.status))
    cb = batch.make_code_bank([assemble("STOP")], st.visited.shape[1], prune_revert=True, device="cpu")
    unsat = st.alive.clone()
    for reverse in (0, 1):
        s = _clone(st)
        scratch = batch.StateBatch(*(torch.empty_like(x) for x in s))
        acc, pv = torch.zeros(4, dtype=torch.int32), torch.zeros(cb.code.shape, dtype=torch.bool)
        ctl = torch.tensor([6, 1, 7, 1], dtype=torch.int32)
        _emu_epilogue(emu, cb, s, scratch, unsat, acc, pv, ctl, 16, n,
                      kernels.EPI_COMMIT | kernels.EPI_COMPACT_ONLY, torch.tensor([gate], dtype=torch.int32), reverse)
        _assert_same(s, megakernel.compact_plain(st, n) if gate else st, f"n={n} gate={gate} reverse={reverse}")
        assert not acc.any() and not pv.any() and ctl.tolist() == [7, 1, 7, 1]


def _emu_fused_mesh(lib, cb, st, n, max_rounds, steps_per_round, with_solve, pool, with_stats, launches=None):
    """run_fused_mesh's card loop, with the emulated kernels: one K1
    launch a round (with stats its stats instance), K3, K4, one launch of
    the steal kernel (plan, decision and gated moves), K4. ``launches``
    (a dict) counts the launches by kernel."""
    L = st.pc.shape[0]
    s = _clone(st)
    hist = torch.zeros(256 if with_stats else 1, dtype=torch.int32)
    scratch = batch.StateBatch(*(torch.empty_like(x) for x in s))
    ctl = torch.zeros(4, dtype=torch.int32)
    ctl[1] = int(bool((s.alive & (s.status == 0)).any()) and max_rounds > 0)
    acc = torch.zeros(4, dtype=torch.int32)
    pv = torch.zeros(cb.code.shape, dtype=torch.bool)
    unsat = torch.zeros(L, dtype=torch.bool)
    mctl = torch.zeros(4, dtype=torch.int32)
    for _ in range(max_rounds):
        for x, y in zip(s, _emu_k1(lib, cb, s, n, steps_per_round, ctl=ctl, hist=hist if with_stats else None)):
            x.copy_(y)
        if with_solve and ctl[1]:
            pl = kernels.planes(s, 1, cb.code.shape[1])
            assert lib.emu_unsat(ctypes.byref(pl), ctypes.byref(kernels.pool_struct(pool)), _vp(unsat), 0) == 0
        _emu_epilogue(lib, cb, s, scratch, unsat, acc, pv, ctl, max_rounds, n, 0)
        _emu_steal(lib, s, n, kernels.MESH_STEAL_ROUND, mctl=mctl, ctl=ctl, nblocks=2)
        if launches is not None:
            launches["steal"] = launches.get("steal", 0) + 1
        _emu_epilogue(lib, cb, s, scratch, unsat, acc, pv, ctl, max_rounds, n,
                      kernels.EPI_COMMIT | kernels.EPI_COMPACT_ONLY, mctl)
    return s, megakernel._mesh_info(ctl[0], acc, mctl[2], mctl[3], s, n), pv, hist


@pytest.mark.parametrize("name", ["spin", "stress"])
def test_fused_mesh_loop_logic_matches_twin(emu, name):
    if name == "spin":  # eight spinning lanes in shards 0-1: steals fire
        cb = batch.make_code_bank([assemble("here:\nJUMPDEST\nPUSH1 :here\nJUMP")], CFG.code_len, device="cpu")
        st = batch.build_batch(CFG, [dict(calldata=b"", gas=10_000_000)] * 4, device="cpu")
        rounds, steps = 3, 16
    else:
        cb, st = _inputs("stress", 9)
        rounds, steps = 4, 24
    pool = inloop_solve.empty_pool("cpu")
    want = megakernel.run_fused_mesh(mesh.make_mesh(8, device="cpu"), cb, None, st, max_rounds=rounds,
                                     steps_per_round=steps, with_stats=True, with_solve=True)
    s, info, pv, hist = _emu_fused_mesh(emu, cb, st, 8, rounds, steps, True, pool, True)
    _assert_same(s, want.st, f"{name} fused mesh")
    assert info.tolist() == want.info.tolist()
    assert torch.equal(pv, want.pruned_visited) and torch.equal(hist, want.hist)
    stats = megakernel.decode_mesh_info(want.info, 8)
    if name == "spin":
        assert stats.steal_events == 1 and stats.steal_lanes == 2 and stats.rounds == 3


@pytest.mark.parametrize("with_stats", [True, False], ids=["stats_on", "stats_off"])
@pytest.mark.parametrize("n", [1, 2])
def test_fused_mesh_loop_one_launch_a_round(emu, n, with_stats):
    """The fused mesh loop as the card runs it, one K1 launch and one
    steal launch a round, the histogram folded inside K1, against the
    twin's loop over one and two lane shards, stats on and off: every
    plane, info, pruned_visited and the histogram."""
    cb, st = _inputs("bectoken", 9)
    pool = inloop_solve.empty_pool("cpu")
    want = megakernel.run_fused_mesh_plain(cb, st, n, 3, 24, True, pool, with_stats)
    launches = {}
    s, info, pv, hist = _emu_fused_mesh(emu, cb, st, n, 3, 24, True, pool, with_stats, launches)
    assert launches == {"steal": 3}  # one steal launch a round: no separate plan or move
    _assert_same(s, want.st, f"n={n} stats={with_stats}")
    assert info.tolist() == want.info.tolist()
    assert torch.equal(pv, want.pruned_visited) and torch.equal(hist, want.hist)
    assert (int(hist.sum()) > 0) == with_stats
