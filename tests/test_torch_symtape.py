"""Port vs reference: term-tape hashing and the CSE allocator
(mythril_tpu_torch/laser/cuda/symtape.py against
mythril_tpu/laser/tpu/symtape.py), bit for bit on the CPU: node_hash
bits, CSE hits and ids, rows a masked-off lane leaves alone, and the
overflow ``ok`` flag."""

import jax.numpy as jnp
import numpy as np
import torch

from mythril_tpu.laser.tpu import symtape as rs
from mythril_tpu_torch.laser.cuda import symtape as ps
from mythril_tpu_torch.laser.cuda import words as pw


def test_node_hash_bits_match_reference():
    rng = np.random.default_rng(0)
    n = 64
    op = rng.integers(0, 64, n).astype(np.int32)
    a = rng.integers(-1, 300, n).astype(np.int32)
    b = rng.integers(-1, 300, n).astype(np.int32)
    imm = rng.integers(0, 1 << 16, (n, 16)).astype(np.uint32)
    r1, r2 = rs.node_hash(jnp.asarray(op), jnp.asarray(a), jnp.asarray(b), jnp.asarray(imm))
    p1, p2 = ps.node_hash(torch.as_tensor(op), torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(imm.astype(np.int64)))
    assert np.array_equal(np.asarray(r1), p1.numpy().astype(np.uint32))
    assert np.array_equal(np.asarray(r2), p2.numpy().astype(np.uint32))
    # the numpy host form used by the tape writers
    for i in range(4):
        hr = rs.node_hash(int(op[i]), int(a[i]), int(b[i]), imm[i], xp=np)
        hp = ps.node_hash(int(op[i]), int(a[i]), int(b[i]), imm[i])
        assert (int(hr[0]), int(hr[1])) == (int(hp[0]), int(hp[1]))


def _tapes(L, T, seed):
    """Random live tapes; some lanes full. Row hashes are real node
    hashes, so exact duplicates CSE-hit."""
    rng = np.random.default_rng(seed)
    D = 16
    t = {
        "tape_op": rng.integers(3, 45, (L, T)).astype(np.int32),
        "tape_a": rng.integers(-1, 5, (L, T)).astype(np.int32),
        "tape_b": rng.integers(-1, 5, (L, T)).astype(np.int32),
        "tape_imm": rng.integers(0, 3, (L, T * D)).astype(np.uint32),
        "tape_meta": rng.integers(0, 1 << 32, (L, T), dtype=np.uint64).astype(np.uint32),
        "tape_len": rng.integers(0, T + 1, L).astype(np.int32),
    }
    t["tape_len"][:2] = T  # full tapes
    h1, h2 = rs.node_hash(t["tape_op"], t["tape_a"], t["tape_b"], t["tape_imm"].reshape(L, T, D), xp=np)
    t["tape_h1"], t["tape_h2"] = h1, h2
    return t


def test_alloc_ids_hits_and_overflow_match_reference():
    L, T, D = 24, 12, 16
    t = _tapes(L, T, 1)
    rng = np.random.default_rng(2)
    # half the requests copy an existing row (CSE hit), half are new
    src = rng.integers(0, T, L)
    lane = np.arange(L)
    op = np.where(lane % 2 == 0, t["tape_op"][lane, src], rng.integers(3, 45, L)).astype(np.int32)
    a = np.where(lane % 2 == 0, t["tape_a"][lane, src], 7).astype(np.int32)
    b = np.where(lane % 2 == 0, t["tape_b"][lane, src], 9).astype(np.int32)
    imm = t["tape_imm"].reshape(L, T, D)[lane, src].copy()
    imm[lane % 2 == 1] = rng.integers(0, 1 << 16, (L // 2, D))
    mask = rng.random(L) < 0.8
    meta = rng.integers(0, 1 << 32, L, dtype=np.uint64).astype(np.uint32)
    order = ("tape_op", "tape_a", "tape_b", "tape_imm", "tape_h1", "tape_h2", "tape_meta", "tape_len")
    ref_tapes, ref_id, ref_ok = rs._alloc_impl(
        tuple(jnp.asarray(t[k]) for k in order),
        jnp.asarray(mask), jnp.asarray(op), jnp.asarray(a), jnp.asarray(b), jnp.asarray(imm), jnp.asarray(meta),
    )
    from mythril_tpu_torch.laser.cuda import convert

    pt = {k: convert.to_tensor(t[k], t[k].dtype, "cpu") for k in order}
    p_id, p_ok = ps.alloc(
        pt, torch.as_tensor(mask), torch.as_tensor(op), torch.as_tensor(a), torch.as_tensor(b),
        torch.as_tensor(imm.astype(np.int64)), torch.as_tensor(meta.astype(np.int64)),
    )
    assert np.array_equal(np.asarray(ref_id), p_id.numpy())
    assert np.array_equal(np.asarray(ref_ok), p_ok.numpy())
    for k, rv in zip(order, ref_tapes):
        assert np.array_equal(np.asarray(rv), convert.to_numpy(pt[k], t[k].dtype)), k
    # the case mix the comparison covered
    ok = p_ok.numpy()
    assert (~ok).any() and ok.any()
    hits = mask & (p_id.numpy() > 0) & (p_id.numpy() <= t["tape_len"])
    assert hits.any()


def test_pack_meta_and_host_helpers():
    pc = torch.tensor([0, 5, 0xFFFF, 0x1FFFF])
    pl = torch.tensor([0, 3, 0xFFFF, 7])
    got = ps.pack_meta(pc, pl).numpy().astype(np.uint32)
    want = np.asarray(rs.pack_meta(jnp.asarray(pc.numpy()), jnp.asarray(pl.numpy())))
    assert np.array_equal(got, want)
    assert ps.unpack_meta(ps.HOST_META) is None
    d = bytes(range(32))
    assert np.array_equal(ps.sha3_imm(64, d), rs.sha3_imm(64, d))
    fp_r = rs.path_fingerprint([1, 2, 3], [4, 5, 6], [1, 0, 1])
    fp_p = ps.path_fingerprint([1, 2, 3], [4, 5, 6], [1, 0, 1])
    assert np.array_equal(fp_r, fp_p)
    assert pw.to_int(ps.sha3_imm(64)) == 64
