"""Port vs reference: the in-loop UNSAT screen
(mythril_tpu_torch/laser/cuda/inloop_solve.py against
mythril_tpu/laser/tpu/inloop_solve.py), bit for bit on the CPU, on pools
built with the reference's make_pool from numpy and random paths that
exercise R1, R3 and unit propagation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.laser.tpu import batch as rb
from mythril_tpu.laser.tpu import inloop_solve as ri
from mythril_tpu_torch.laser.cuda import convert
from mythril_tpu_torch.laser.cuda import inloop_solve as pi

CFG = dict(lanes=48, stack_slots=4, memory_bytes=32, calldata_bytes=32, storage_slots=2,
           code_len=64, tape_slots=24, path_slots=12, mem_sym_slots=2, ss_ring=4)


def _case(seed, iszero_share=0.3, used_share=0.3, n_hash=10):
    r = np.random.default_rng(seed)
    L, T, P = CFG["lanes"], CFG["tape_slots"], CFG["path_slots"]
    planes = {k: np.zeros(shape, dtype) for k, (shape, dtype) in rb.batch_shapes(rb.BatchConfig(**CFG)).items()}
    hs = r.integers(0, 2**32, (n_hash, 2), dtype=np.uint64).astype(np.uint32)
    pick = r.integers(0, n_hash, (L, T))
    planes["alive"] = r.random(L) < 0.9
    planes["status"] = r.choice([0, 0, 0, 5, 1], L).astype(np.int32)
    planes["path_len"] = r.integers(0, P + 1, L).astype(np.int32)
    planes["path_id"] = r.integers(0, T + 3, (L, P)).astype(np.int32)
    planes["path_sign"] = r.random((L, P)) < 0.5
    planes["tape_op"] = np.where(r.random((L, T)) < iszero_share, 32, 10).astype(np.int32)
    planes["tape_a"] = r.integers(-1, T + 1, (L, T)).astype(np.int32)
    planes["tape_h1"], planes["tape_h2"] = hs[pick, 0], hs[pick, 1]
    V, C, W = ri.POOL_VARS, ri.POOL_CLAUSES, ri.POOL_WIDTH
    vsel = r.integers(0, n_hash, V)
    pool_np = dict(
        var_h1=hs[vsel, 0], var_h2=hs[vsel, 1],
        lit_var=r.integers(-2, V + 2, (C, W)).astype(np.int32),  # a few out-of-range literals
        lit_neg=r.random((C, W)) < 0.5, lit_used=r.random((C, W)) < used_share,
    )
    return planes, pool_np


@pytest.mark.parametrize("seed", range(6))
def test_unsat_mask_matches_reference(seed):
    planes, pool_np = _case(seed, iszero_share=0.1 * (seed % 3), used_share=0.15 + 0.05 * seed)
    ref_st = rb.StateBatch(**{k: jnp.asarray(v) for k, v in planes.items()})
    ref_pool = ri.make_pool(**pool_np)
    want = np.asarray(ri.unsat_mask(ref_pool, ref_st))
    st = convert.batch_to_torch(planes, "cpu")
    pool = convert.pool_to_torch(pool_np, "cpu")
    got = pi.unsat_mask(pool, st, device="cpu").numpy()
    assert np.array_equal(want, got)
    assert got.any() and not got.all()


def test_empty_pool_matches_reference():
    planes, _ = _case(11)
    ref_st = rb.StateBatch(**{k: jnp.asarray(v) for k, v in planes.items()})
    want = np.asarray(ri.unsat_mask(ri.empty_pool(), ref_st))
    got = pi.unsat_mask(pi.empty_pool("cpu"), convert.batch_to_torch(planes, "cpu"), device="cpu").numpy()
    assert np.array_equal(want, got)


def test_pool_round_trip():
    _, pool_np = _case(3)
    back = convert.pool_to_numpy(convert.pool_to_torch(pool_np, "cpu"))
    for k, v in pool_np.items():
        assert back[k].tobytes() == v.tobytes(), k
    assert torch.equal(convert.pool_to_torch(pool_np, "cpu").lit_used, torch.as_tensor(pool_np["lit_used"]))
