"""Port vs reference: the mesh module (mythril_tpu_torch/laser/cuda/mesh.py
against mythril_tpu/laser/tpu/mesh.py), the mesh tier policy of the
backend, and the per-shard download, bit for bit on the CPU.

- ``rebalance``, ``occupancy_impl``, ``occupancy`` and the
  ``should_rebalance*`` gates on the reference's own cases;
- ``steal_plan``/``steal_apply`` against the reference run inside a
  ``shard_map`` over the virtual 8-device mesh (as the fused loop's body
  runs them), on the reference test's tagged batches: every plan field
  and every plane at every lane;
- ``_mesh_tier``/``planned_mesh_factor`` over the reference test's
  table, with "cuda" where the reference says "tpu";
- ``batch_to_host(n_shards=8)``: the bytes of both downloads and the
  planes equal the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mythril_tpu.laser.tpu import batch as rb
from mythril_tpu.laser.tpu import mesh as rmesh
from mythril_tpu.laser.tpu import transfer as ref_transfer
from mythril_tpu_torch.laser.cuda import backend, convert, mesh
from mythril_tpu_torch.laser.cuda import batch as pb
from mythril_tpu_torch.laser.cuda import transfer as port_transfer

N_SHARDS = 8
CFG = dict(lanes=16, stack_slots=16, memory_bytes=256, calldata_bytes=64, storage_slots=4, code_len=256)


def _both(np_planes: dict):
    """The same planes as a reference batch and a port batch."""
    ref = rb.StateBatch(**{k: jnp.asarray(v) for k, v in np_planes.items()})
    return ref, convert.batch_to_torch(np_planes, "cpu")


def _empty_np(cfg):
    return {k: np.zeros(shape, dt) for k, (shape, dt) in rb.batch_shapes(rb.BatchConfig(**cfg)).items()}


def _assert_same(ref_st, port_st, where):
    got = convert.batch_to_numpy(port_st)
    for field in rb.StateBatch._fields:
        r = np.asarray(getattr(ref_st, field))
        if not np.array_equal(r, got[field]):
            idx = tuple(np.argwhere(r != got[field])[0])
            raise AssertionError(f"{where}: plane {field}{list(idx)} ref={r[idx]} port={got[field][idx]}")


def _tagged(running_lanes, halted_lanes=()):
    """The reference test's tagged batch (test_mesh_fused.py:205): every
    lane's planes carry its index, alive lanes a dense prefix per shard."""
    nb = _empty_np(CFG)
    L = CFG["lanes"]
    nb["status"][:] = rb.STOPPED
    for lane in running_lanes:
        nb["alive"][lane], nb["status"][lane] = True, rb.RUNNING
    for lane in halted_lanes:
        nb["alive"][lane], nb["status"][lane] = True, rb.STOPPED
    nb["pc"][:] = 100 + np.arange(L)
    nb["steps"][:] = 1000 + np.arange(L)
    nb["gas_left"][:] = 5000 + np.arange(L)
    nb["stack"][:, 0] = np.arange(L)
    nb["static_pruned"][:] = 7
    for lane in range(L):
        nb["visited"][lane, lane % nb["visited"].shape[1]] = True
    return nb


# -- rebalance, occupancy and the gates ---------------------------------


def _deal_case():
    cfg = dict(lanes=64, stack_slots=4, memory_bytes=32, calldata_bytes=32, storage_slots=2, code_len=32)
    nb = _empty_np(cfg)
    running = list(range(10)) + [17, 23, 31]
    nb["alive"][running] = True
    nb["alive"][[40, 41]] = True  # alive, not running
    nb["status"][[40, 41]] = rb.STOPPED
    nb["pc"][:] = np.arange(64)
    return nb


@pytest.mark.parametrize("n", [8, 4, 2, 1, 3])
def test_rebalance_and_occupancy_match_reference(n):
    ref, port = _both(_deal_case())
    _assert_same(rmesh.rebalance(ref, n), mesh.rebalance(port, n, device="cpu"), f"rebalance n={n}")
    if 64 % n == 0:
        occ = mesh.occupancy_impl(port, n, device="cpu")
        assert occ.dtype == torch.int32
        assert occ.tolist() == np.asarray(rmesh.occupancy_impl(ref, n)).tolist()
        assert mesh.occupancy(port, n).tolist() == rmesh.occupancy(ref, n).tolist()
    assert mesh.should_rebalance(port, n) == rmesh.should_rebalance(ref, n)


def test_rebalance_deals_running_lanes_evenly():
    _ref, port = _both(_deal_case())
    out = mesh.rebalance(port, N_SHARDS, device="cpu")
    occ = mesh.occupancy(out, N_SHARDS)
    assert occ.sum() == 13 and occ.max() - occ.min() <= 1
    assert sorted(out.pc.tolist()) == list(range(64))


def test_should_rebalance_gates_match_reference():
    cases = []
    for alive in ([0, 1, 2, 3], list(range(16)), [0, 2], []):
        nb = _empty_np(CFG)
        nb["alive"][alive] = True
        cases.append(nb)
    for nb in cases:
        ref, port = _both(nb)
        for n in (8, 3, 1):
            assert mesh.should_rebalance(port, n) == rmesh.should_rebalance(ref, n)
    for occ in ([2, 2, 0, 0], [1, 1, 1, 0], [0, 0], [3], [5, 0]):
        assert mesh.should_rebalance_occ(occ) == rmesh.should_rebalance_occ(np.array(occ))


# -- the steal --------------------------------------------------------------


def _ref_steal(ref_st):
    """The reference's plan and (moved > 0) apply inside shard_map, as the
    reference test's ``_steal_once`` runs them."""
    from jax.experimental.shard_map import shard_map

    m = rmesh.make_mesh(N_SHARDS)

    def body(s):
        plan = rmesh.steal_plan(s, N_SHARDS)
        s2 = jax.lax.cond(plan.moved > 0, lambda x: rmesh.steal_apply(x, plan, N_SHARDS), lambda x: x, s)
        return s2, plan

    plan_spec = rmesh.StealPlan(export=P("paths"), buf_pos=P("paths"), filled=P(), occ=P(), alive_c=P(),
                                moved=P())
    fn = shard_map(body, mesh=m, in_specs=(P("paths"),), out_specs=(P("paths"), plan_spec), check_rep=False)
    return jax.jit(fn)(rmesh.shard_batch(ref_st, m))


STEAL_CASES = {
    "skew": ([0, 1, 2, 3], ()),
    "capacity": ([0, 1, 2, 3], (4, 5)),
    "balanced": ([0, 2, 4, 6, 8, 10, 12, 14], ()),
    "empty": ([], ()),
    "one_heavy_shard": ([0, 1, 4, 6, 8], (2, 3, 10, 11)),
}


@pytest.mark.parametrize("case", sorted(STEAL_CASES))
def test_steal_plan_and_apply_match_reference(case):
    ref, port = _both(_tagged(*STEAL_CASES[case]))
    ref_out, ref_plan = _ref_steal(ref)
    plan = mesh.steal_plan(port, N_SHARDS, device="cpu")
    for field in rmesh.StealPlan._fields:
        r = np.asarray(getattr(ref_plan, field))
        got = getattr(plan, field).numpy()
        assert got.dtype == (np.bool_ if field == "export" else np.int32), field
        assert np.array_equal(got, r), f"{case}: plan.{field} {got.tolist()} ref {r.tolist()}"
    out = mesh.steal_apply(port, plan, N_SHARDS, device="cpu") if int(plan.moved) > 0 else port
    _assert_same(ref_out, out, f"{case} apply")


def test_steal_moves_the_reference_tests_counts():
    # test_mesh_fused.py's expectations, on the port alone
    _r, port = _both(_tagged([0, 1, 2, 3]))
    plan = mesh.steal_plan(port, N_SHARDS, device="cpu")
    assert plan.occ.tolist() == [2, 2, 0, 0, 0, 0, 0, 0] and int(plan.moved) == 2
    out = mesh.steal_apply(port, plan, N_SHARDS, device="cpu")
    assert mesh.occupancy(out, N_SHARDS).tolist() == [1, 1, 1, 1, 0, 0, 0, 0]
    _r, port = _both(_tagged([0, 1, 2, 3], (4, 5)))
    plan = mesh.steal_plan(port, N_SHARDS, device="cpu")
    out = mesh.steal_apply(port, plan, N_SHARDS, device="cpu")
    assert int(plan.moved) == 1 and mesh.occupancy(out, N_SHARDS).tolist() == [1, 2, 0, 1, 0, 0, 0, 0]


# -- the tier policy ------------------------------------------------------


def test_mesh_tier_policy(monkeypatch):
    monkeypatch.delenv("MYTHRIL_TPU_MESH", raising=False)
    monkeypatch.delenv("MYTHRIL_TPU_FUSED", raising=False)
    assert backend._mesh_tier(8, "cpu") == "off"
    assert backend._mesh_tier(8, "cuda") == "fused"
    assert backend._mesh_tier(1, "cuda") == "off"
    monkeypatch.setenv("MYTHRIL_TPU_MESH", "on")
    assert backend._mesh_tier(8, "cpu") == "fused"
    monkeypatch.setenv("MYTHRIL_TPU_MESH", "sync")
    assert backend._mesh_tier(8, "cpu") == "sync"
    monkeypatch.setenv("MYTHRIL_TPU_MESH", "off")
    assert backend._mesh_tier(8, "cuda") == "off"
    monkeypatch.setenv("MYTHRIL_TPU_MESH", "on")
    monkeypatch.setenv("MYTHRIL_TPU_FUSED", "off")
    assert backend._mesh_tier(8, "cpu") == "sync"
    monkeypatch.delenv("MYTHRIL_TPU_FUSED", raising=False)
    monkeypatch.setenv("MYTHRIL_TPU_MESH", "bogus")
    assert backend._mesh_tier(8, "cpu") == "off"


def test_planned_mesh_factor(monkeypatch):
    monkeypatch.setattr(backend, "DEVICE", "cpu")
    monkeypatch.setattr(mesh, "n_devices", lambda device="cuda": 8)
    monkeypatch.setenv("MYTHRIL_TPU_MESH", "on")
    assert backend.planned_mesh_factor() == backend.MESH_WATCHDOG_FACTOR
    monkeypatch.setenv("MYTHRIL_TPU_MESH", "off")
    assert backend.planned_mesh_factor() == 1.0
    # one card: the mesh never engages, whatever the mode
    monkeypatch.setattr(mesh, "n_devices", lambda device="cuda": 1)
    monkeypatch.setenv("MYTHRIL_TPU_MESH", "on")
    assert backend.planned_mesh_factor() == 1.0


def test_n_devices_is_one_device():
    # one device on the CPU and on a host with one card or none: the
    # mesh counts the cards that reach each other's memory, so production
    # takes it only on a host with two or more such cards
    assert mesh.n_devices("cpu") == 1
    assert 1 <= mesh.n_devices("cuda") <= max(1, torch.cuda.device_count())
    if torch.cuda.device_count() < 2:
        assert mesh.n_devices("cuda") == 1
    assert mesh.make_mesh(8, device="cpu") is mesh.make_mesh(8, device="cpu")
    assert mesh.make_mesh(device="cpu").n == 1


# -- the per-shard download ------------------------------------------------


def _capture(monkeypatch, module):
    log = []
    unp = module._unpack_host

    def unpack_host(buf, shapes):
        log.append(np.array(buf))
        return unp(buf, shapes)

    monkeypatch.setattr(module, "_unpack_host", unpack_host)
    return log


@pytest.mark.parametrize("counts", [[3, 0, 7, 16, 1, 0, 2, 5], [0] * 8, [32] + [0] * 7])
def test_batch_to_host_per_shard_matches_reference(monkeypatch, counts):
    cfg = dict(lanes=256, stack_slots=4, memory_bytes=32, calldata_bytes=32, storage_slots=2, code_len=32,
               tape_slots=16, path_slots=4, mem_sym_slots=2, ss_ring=4)
    rng = np.random.default_rng(sum(counts))
    nb = {}
    for name, (shape, dtype) in rb.batch_shapes(rb.BatchConfig(**cfg)).items():
        if dtype == np.bool_:
            nb[name] = rng.integers(0, 2, shape).astype(bool)
        else:
            nb[name] = rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)
    nb["tape_len"][:] = 3
    for f in ref_transfer._TAPE_PLANES:
        nb[f][:, 3 * (16 if f == "tape_imm" else 1):] = 0
    per = 256 // N_SHARDS
    nb["alive"][:] = False
    for s, c in enumerate(counts):
        nb["alive"][s * per: s * per + c] = True  # a dense prefix per shard
    ref_log = _capture(monkeypatch, ref_transfer)
    port_log = _capture(monkeypatch, port_transfer)
    ref_back = ref_transfer.batch_to_host(ref_transfer.batch_to_device(nb, rb.BatchConfig(**cfg)),
                                          n_shards=N_SHARDS)
    port_st = port_transfer.batch_to_device(nb, pb.BatchConfig(**cfg), device="cpu")
    port_back = port_transfer.batch_to_host(port_st, n_shards=N_SHARDS)
    for name in nb:
        assert np.array_equal(getattr(port_back, name), getattr(ref_back, name)), name
    assert len(port_log) == len(ref_log) == 2
    for r, p in zip(ref_log, port_log):
        assert np.array_equal(p, r)
    if counts[0] != 32 and any(counts):
        # not a global prefix: every shard ships the first 16 of its 32 lanes
        assert port_transfer.shard_plan(nb["alive"], N_SHARDS) == (N_SHARDS, 16)
        full = port_transfer.pack_plain(port_st, port_transfer._BIG_DOWN, 16).numel()
        assert port_log[1].nbytes * 2 == full
