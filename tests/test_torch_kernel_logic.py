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


def _emu_step(lib, cb, st):
    st = batch.StateBatch(*(x.clone() for x in st))
    sc = kernels.Scratch.get(torch.device("cpu"), st.pc.shape[0])
    pl = kernels.planes(st, cb.code.shape[0], cb.code.shape[1])
    bk = kernels.bank(cb)
    rc = lib.emu_step(ctypes.byref(pl), ctypes.byref(bk), _vp(sc.tab), _vp(sc.slot), _vp(sc.fork_do),
                      _vp(sc.fork_dest), _vp(sc.sha_active), _vp(sc.sha_off), _vp(sc.sha_avail),
                      _vp(sc.sha_len), _vp(sc.sha_digest))
    assert rc == 0
    return st


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


def _emu_fused(lib, cb, st, max_rounds, steps_per_round, with_solve, pool):
    """run_fused's card loop, with the emulated kernels."""
    L = st.pc.shape[0]
    s = batch.StateBatch(*(x.clone() for x in st))
    scratch = batch.StateBatch(*(torch.empty_like(x) for x in s))
    ctl = torch.zeros(4, dtype=torch.int32)
    ctl[1] = int(bool((s.alive & (s.status == 0)).any()) and max_rounds > 0)
    acc = torch.zeros(4, dtype=torch.int32)
    pv = torch.zeros(cb.code.shape, dtype=torch.bool)
    sc = kernels.Scratch.get(torch.device("cpu"), L)
    for _ in range(max_rounds):
        for _ in range(steps_per_round):
            if ctl[1]:
                for x, y in zip(s, _emu_step(lib, cb, s)):
                    x.copy_(y)
        unsat = torch.zeros(L, dtype=torch.bool)
        if with_solve and ctl[1]:
            pl = kernels.planes(s, 1, cb.code.shape[1])
            assert lib.emu_unsat(ctypes.byref(pl), ctypes.byref(kernels.pool_struct(pool)), _vp(unsat)) == 0
        pl = kernels.planes(s, cb.code.shape[0], cb.code.shape[1])
        psc = kernels.planes(scratch, cb.code.shape[0], cb.code.shape[1])
        assert lib.emu_epilogue(ctypes.byref(pl), ctypes.byref(psc), _vp(cb.prune_revert), _vp(unsat), _vp(acc),
                                _vp(sc.order), _vp(sc.dying), _vp(pv), _vp(ctl), max_rounds) == 0
    return s, megakernel._info(ctl[0], acc, s), pv


@pytest.mark.parametrize("with_solve", [True, False], ids=["solve_on", "solve_off"])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_fused_loop_logic_matches_twin(emu, name, with_solve):
    cb, st = _inputs(name, 9)
    pool = inloop_solve.empty_pool("cpu")
    want = megakernel.run_fused(cb, None, st, max_rounds=4, steps_per_round=24, with_solve=with_solve, device="cpu")
    s, info, pv = _emu_fused(emu, cb, st, 4, 24, with_solve, pool)
    _assert_same(s, want.st, f"{name} fused")
    assert torch.equal(info, want.info) and torch.equal(pv, want.pruned_visited)


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
