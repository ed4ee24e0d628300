"""Port vs reference: the fused mesh super-round
(mythril_tpu_torch/laser/cuda/megakernel.run_fused_mesh_plain against
mythril_tpu/laser/tpu/megakernel.run_fused_mesh on the virtual 8-device
CPU mesh), bit for bit on the CPU.

Under ``shard_map`` each shard places its own forks, compacts its own
block and steals work between rounds, so lane positions are part of the
result: every plane is compared at every lane (free lanes' stale rows
too), with ``info`` (i32[9 + n]), ``pruned_visited`` and the summed
``hist``. The reference's test CFG and 64-step rounds, stats and the
in-loop screen on, keep the reference's super-round to one compile.
Last, one round of the sync mesh tier (``sharded_round`` with the deal,
forks placed over all lanes as GSPMD places them) against the
reference's jitted round."""

import os

import numpy as np
import pytest

import bench
from mythril_tpu.laser.tpu import batch as rb
from mythril_tpu.laser.tpu import megakernel as rm
from mythril_tpu.laser.tpu import mesh as rmesh
from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.laser.cuda import batch as pb
from mythril_tpu_torch.laser.cuda import convert, megakernel, mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SHARDS = 8
STEPS = 64
CFG = dict(lanes=16, stack_slots=16, memory_bytes=256, calldata_bytes=64, storage_slots=4, code_len=256)
HOST_OPS = (0x00, 0xF3, 0xFD, 0xFF, 0xFE)  # the backend's always-host opcodes
BANK_KW = dict(host_ops=HOST_OPS, freeze_errors=True, record_storage_events=True, prune_revert=True)
SYM = dict(symbolic_calldata=True, symbolic_storage=True, symbolic_caller=True, symbolic_callvalue=True)

# the reference test's countdown (tests/laser/test_mesh_fused.py): lane i
# spins calldataload(0) iterations, so shards drain at different rounds
COUNTDOWN_SRC = """
    PUSH1 0x00
    CALLDATALOAD
loop:
    JUMPDEST
    DUP1
    ISZERO
    PUSH2 :done
    JUMPI
    PUSH1 0x01
    SWAP1
    SUB
    PUSH2 :loop
    JUMP
done:
    JUMPDEST
    STOP
"""


def _countdown():
    # eight lanes in shards 0-3: shards 4-7 have free lanes to take work
    code = assemble(COUNTDOWN_SRC)
    specs = [dict(calldata=(lane * 7 + 1).to_bytes(32, "big"), gas=10_000_000) for lane in range(8)]
    return code, {}, specs


def _becstress():
    rng = np.random.default_rng(11)
    conc = [dict(calldata=int(rng.integers(1, 1 << 30)).to_bytes(32, "big")
                 + int(rng.integers(0, 4)).to_bytes(32, "big"), caller=0x1000 + i) for i in range(2)]
    return assemble(bench.STRESS_SRC), BANK_KW, [dict(SYM), dict(SYM)] + conc


# becstress's four seeds go to lanes 0, 2, 4, 6: one free lane in each of
# shards 0-3, so a shard's first fork lands in its own block and its
# second traps with fork_no_slot while other shards have room
SPREAD = np.array([0, 8, 1, 9, 2, 10, 3, 11, 4, 12, 5, 13, 6, 14, 7, 15])


WORKLOADS = {"countdown": _countdown, "becstress": _becstress}


def _pair(name):
    code, bank_kw, specs = WORKLOADS[name]()
    rcb = rb.make_code_bank([code], CFG["code_len"], **bank_kw)
    rst = rb.build_batch(rb.BatchConfig(**CFG), specs)
    pcb = pb.make_code_bank([code], CFG["code_len"], device="cpu", **bank_kw)
    pst = pb.build_batch(pb.BatchConfig(**CFG), specs, device="cpu")
    if name == "becstress":
        rst = rst._replace(**{f: getattr(rst, f)[SPREAD] for f in rb.StateBatch._fields})
        pst = pb.StateBatch(*(x[SPREAD] for x in pst))
    return (rcb, rst), (pcb, pst)


def _assert_same(ref_st, port_st, where):
    got = convert.batch_to_numpy(port_st)
    for field in rb.StateBatch._fields:
        r = np.asarray(getattr(ref_st, field))
        if not np.array_equal(r, got[field]):
            idx = tuple(np.argwhere(r != got[field])[0])
            raise AssertionError(f"{where}: plane {field}{list(idx)} ref={r[idx]} port={got[field][idx]}")


def _ref_mesh_run(rcb, rst, max_rounds):
    m = rmesh.make_mesh(N_SHARDS)
    st = rmesh.shard_batch(rst, m)
    cb, env = rmesh.put_replicated((rcb, rb.default_env()), m)
    return rm.run_fused_mesh(m, cb, env, st, max_rounds=max_rounds, steps_per_round=STEPS,
                             with_stats=True, with_solve=True)


@pytest.mark.parametrize("name,max_rounds", [("countdown", 20), ("becstress", 4)])
def test_run_fused_mesh_matches_reference(name, max_rounds):
    (rcb, rst), (pcb, pst) = _pair(name)
    ro = _ref_mesh_run(rcb, rst, max_rounds)
    pm = mesh.make_mesh(N_SHARDS, device="cpu")
    po = megakernel.run_fused_mesh(pm, pcb, None, pst, max_rounds=max_rounds, steps_per_round=STEPS,
                                   with_stats=True, with_solve=True)
    _assert_same(ro.st, po.st, f"{name} mesh st")
    assert np.asarray(ro.info).tolist() == po.info.tolist()
    assert np.array_equal(np.asarray(ro.pruned_visited), po.pruned_visited.numpy())
    assert np.array_equal(np.asarray(ro.hist), po.hist.numpy().view(np.uint32))
    stats = megakernel.decode_mesh_info(po.info, N_SHARDS)
    assert tuple(stats) == tuple(rm.decode_mesh_info(ro.info, N_SHARDS))
    if name == "countdown":
        # every lane stops; the shards drained at different rounds and
        # the steal evened them out first
        assert stats.n_alive == 8 and stats.n_running == 0 and stats.steal_events >= 1
    else:
        # forks filled lanes, and some parent found its shard full
        assert stats.n_alive + stats.pruned_lanes + stats.inloop_kills > 4


def test_run_fused_mesh_skew_demo_matches_reference():
    # MULTICHIP_r06's skew demo cut to the test CFG: 4 spinning lanes on
    # shards 0-1; one steal evens them out and no lane loses a step
    code = assemble("here:\nJUMPDEST\nPUSH1 :here\nJUMP")
    specs = [dict(calldata=b"", gas=10_000_000) for _ in range(4)]
    rcb = rb.make_code_bank([code], CFG["code_len"])
    rst = rb.build_batch(rb.BatchConfig(**CFG), specs)
    pcb = pb.make_code_bank([code], CFG["code_len"], device="cpu")
    pst = pb.build_batch(pb.BatchConfig(**CFG), specs, device="cpu")
    ro = _ref_mesh_run(rcb, rst, 3)
    po = megakernel.run_fused_mesh(mesh.make_mesh(N_SHARDS, device="cpu"), pcb, None, pst, max_rounds=3,
                                   steps_per_round=STEPS, with_stats=True, with_solve=True)
    _assert_same(ro.st, po.st, "skew st")
    assert np.asarray(ro.info).tolist() == po.info.tolist()
    stats = megakernel.decode_mesh_info(po.info, N_SHARDS)
    assert stats.steal_events == 1 and stats.steal_lanes == 2
    assert max(stats.occupancy) - min(stats.occupancy) <= 1
    assert int(po.st.steps.sum()) == 4 * 3 * STEPS


def test_run_fused_mesh_rejects_indivisible_lanes():
    cfg = pb.BatchConfig(**dict(CFG, lanes=12))
    cb = pb.make_code_bank([assemble(COUNTDOWN_SRC)], cfg.code_len, device="cpu")
    st = pb.empty_batch(cfg, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        megakernel.run_fused_mesh(mesh.make_mesh(N_SHARDS, device="cpu"), cb, None, st, max_rounds=1,
                                  steps_per_round=STEPS)


def test_one_shard_is_the_single_device_loop():
    # n = 1: the mesh loop's per-shard ranks and compaction are the
    # single-device ones, and no steal can fire
    _, (pcb, pst) = _pair("becstress")
    one = megakernel.run_fused_mesh(mesh.make_mesh(1, device="cpu"), pcb, None, pst, max_rounds=2,
                                    steps_per_round=24, with_solve=True)
    single = megakernel.run_fused(pcb, None, pst, max_rounds=2, steps_per_round=24, with_solve=True,
                                  device="cpu")
    for x, y in zip(one.st, single.st):
        assert x.equal(y)
    i = one.info.tolist()
    assert i[:6] + [i[-1]] == single.info.tolist() and i[6:8] == [0, 0]


# -- the sync mesh tier's round ------------------------------------------


def test_sharded_round_with_deal_matches_reference():
    code = assemble(open(os.path.join(ROOT, "bench_contracts", "bectoken.asm")).read())
    rng = np.random.default_rng(4)
    specs = [dict(SYM) for _ in range(3)] + [
        dict(calldata=bytes(rng.integers(0, 256, 64, dtype=np.uint8)), caller=0x1000 + i) for i in range(3)]
    kw = dict(host_ops=HOST_OPS, freeze_errors=True, record_storage_events=True)
    rcb = rb.make_code_bank([code], CFG["code_len"], **kw)
    rst = rb.build_batch(rb.BatchConfig(**CFG), specs)
    pcb = pb.make_code_bank([code], CFG["code_len"], device="cpu", **kw)
    pst = pb.build_batch(pb.BatchConfig(**CFG), specs, device="cpu")
    r_out, r_occ = rmesh.sharded_round(rcb, rb.default_env(), rst, steps_per_round=48, do_rebalance=True,
                                       n_shards=N_SHARDS)
    p_out, p_occ = mesh.sharded_round(pcb, None, pst, steps_per_round=48, do_rebalance=True, n_shards=N_SHARDS,
                                      device="cpu")
    _assert_same(r_out, p_out, "sharded_round")
    assert p_occ.tolist() == np.asarray(r_occ).tolist()
    assert int(p_out.alive.sum()) > 6  # forks were placed before the deal
    with pytest.raises(ValueError):
        mesh.sharded_round(pcb, None, pst, do_rebalance=True, n_shards=1, device="cpu")
