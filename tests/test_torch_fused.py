"""Port vs reference: the step and the fused super-round
(mythril_tpu_torch/laser/cuda/engine.py and megakernel.py against
mythril_tpu/laser/tpu/engine.py and megakernel.py), bit for bit on the
CPU.

Every StateBatch plane is compared after each step on the graft entry's
tiny workload, becstress, BECToken and the in-loop demo, with symbolic
and concrete lanes; then FusedOut's st, info and pruned_visited with the
in-loop screen on and off. One small config keeps the reference's step
to one XLA compile for the file."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import bench
from mythril_tpu.laser.tpu import batch as rb
from mythril_tpu.laser.tpu import engine as re_
from mythril_tpu.laser.tpu import megakernel as rm
from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.laser.cuda import batch as pb
from mythril_tpu_torch.laser.cuda import convert, engine, megakernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(lanes=16, stack_slots=32, memory_bytes=256, calldata_bytes=128, storage_slots=8,
           code_len=512, tape_slots=64, path_slots=16, mem_sym_slots=8, ss_ring=16)
HOST_OPS = (0x00, 0xF3, 0xFD, 0xFF, 0xFE)  # the backend's always-host opcodes
BANK_KW = dict(host_ops=HOST_OPS, freeze_errors=True, record_storage_events=True, prune_revert=True)
SYM = dict(symbolic_calldata=True, symbolic_storage=True, symbolic_caller=True, symbolic_callvalue=True)
SOURCES = {
    "stress": bench.STRESS_SRC,
    "bectoken": open(os.path.join(ROOT, "bench_contracts", "bectoken.asm")).read(),
    "inloop_demo": bench.INLOOP_DEMO_SRC,
}


def _specs(seed):
    rng = np.random.default_rng(seed)
    conc = [
        dict(calldata=int(rng.integers(1, 1 << 30)).to_bytes(32, "big") + int(rng.integers(0, 4)).to_bytes(32, "big"),
             caller=0x1000 + i)
        for i in range(2)
    ]
    return [dict(SYM), dict(SYM)] + conc


def _pair(src, specs):
    code = assemble(src)
    ref = (rb.make_code_bank([code], CFG["code_len"], **BANK_KW), rb.build_batch(rb.BatchConfig(**CFG), specs))
    port = (pb.make_code_bank([code], CFG["code_len"], device="cpu", **BANK_KW),
            pb.build_batch(pb.BatchConfig(**CFG), specs, device="cpu"))
    return ref, port


def _assert_same(ref_st, port_st, where):
    got = convert.batch_to_numpy(port_st)
    for field in rb.StateBatch._fields:
        r = np.asarray(getattr(ref_st, field))
        if not np.array_equal(r, got[field]):
            idx = tuple(np.argwhere(r != got[field])[0])
            raise AssertionError(f"{where}: plane {field}{list(idx)} ref={r[idx]} port={got[field][idx]}")


def _step_both(ref, port, n):
    (rcb, rst), (pcb, pst) = ref, port
    for i in range(n):
        rst = re_.step(rcb, rb.default_env(), rst)
        pst = engine.step(pcb, None, pst, device="cpu")
        _assert_same(rst, pst, f"step {i}")
    return rst, pst


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_step_planes_match_reference_every_step(name):
    ref, port = _pair(SOURCES[name], _specs(len(name)))
    rst, _ = _step_both(ref, port, 48)
    # the run forked and stepped symbolic lanes, so the comparison saw
    # tape allocation, path appends and fork placement
    assert int(np.asarray(rst.alive).sum()) > 4
    assert int(np.asarray(rst.tape_len).max()) > 0


def test_step_planes_match_reference_on_graft_tiny_workload():
    rcb, _env, rst = __graft_entry__._tiny_workload(lanes=8)
    pcb = convert.code_bank_to_torch({k: np.asarray(v) for k, v in rcb._asdict().items()}, "cpu")
    pst = convert.batch_to_torch({k: np.asarray(v) for k, v in rst._asdict().items()}, "cpu")
    rst, _ = _step_both((rcb, rst), (pcb, pst), 40)
    assert np.asarray(rst.storage_used).any() and int(np.asarray(rst.steps).min()) == 40


@pytest.mark.parametrize("with_solve", [True, False], ids=["solve_on", "solve_off"])
@pytest.mark.parametrize("name", ["stress", "inloop_demo"])
def test_run_fused_matches_reference(name, with_solve):
    (rcb, rst), (pcb, pst) = _pair(SOURCES[name], _specs(7))
    ro = rm.run_fused(rcb, rb.default_env(), rst, max_rounds=3, steps_per_round=24, with_solve=with_solve)
    po = megakernel.run_fused(pcb, None, pst, max_rounds=3, steps_per_round=24, with_solve=with_solve, device="cpu")
    _assert_same(ro.st, po.st, "fused st")
    assert np.array_equal(np.asarray(ro.info), po.info.numpy())
    assert np.array_equal(np.asarray(ro.pruned_visited), po.pruned_visited.numpy())
    stats = megakernel.decode_info(po.info)
    assert stats == tuple(rm.decode_info(ro.info))
    if name == "inloop_demo":
        # the must-UNSAT fork dies inside the loop only with the screen on
        assert (stats.inloop_kills >= 1) == with_solve


def test_compaction_keeps_survivor_order():
    (_, _), (pcb, pst) = _pair(SOURCES["stress"], _specs(3))
    out = megakernel.run_fused(pcb, None, pst, max_rounds=2, steps_per_round=16, device="cpu")
    alive = out.st.alive.numpy()
    n = int(alive.sum())
    assert alive[:n].all() and not alive[n:].any()
    assert int(out.info[4]) == n
