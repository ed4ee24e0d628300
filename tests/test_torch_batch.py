"""Port vs reference: code bank and state batch construction
(mythril_tpu_torch/laser/cuda/batch.py against
mythril_tpu/laser/tpu/batch.py), plane for plane on the CPU, including
the static-pass planes, and a round trip through convert.py."""

import os

import numpy as np
import pytest

import bench
from mythril_tpu.disassembler.asm import assemble as ref_assemble
from mythril_tpu.laser.tpu import backend as rbackend
from mythril_tpu.laser.tpu import batch as rb
from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.laser.cuda import batch as pb
from mythril_tpu_torch.laser.cuda import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {
    "stress": bench.STRESS_SRC,
    "inloop_demo": bench.INLOOP_DEMO_SRC,
    "bectoken": open(os.path.join(ROOT, "bench_contracts", "bectoken.asm")).read(),
    "token": open(os.path.join(ROOT, "bench_contracts", "token.asm")).read(),
}
CFG = dict(lanes=8, stack_slots=16, memory_bytes=128, calldata_bytes=96, storage_slots=4,
           code_len=2048, tape_slots=32, path_slots=8, mem_sym_slots=4, ss_ring=8)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_code_bank_planes_match_reference(name):
    code = assemble(SOURCES[name])
    assert code == ref_assemble(SOURCES[name])
    kw = dict(host_ops=(0x00, 0xF3, 0xFD), freeze_errors=True, record_storage_events=True, prune_revert=True)
    ref = rb.make_code_bank([code, code[:7]], 2048, **kw)
    port = pb.make_code_bank([code, code[:7]], 2048, device="cpu", **kw)
    got = convert.code_bank_to_numpy(port)
    for field in rb.CodeBank._fields:
        r = np.asarray(getattr(ref, field))
        assert r.dtype == got[field].dtype, field
        assert np.array_equal(r, got[field]), field
    # the static-pass planes are really populated on these contracts
    if name in ("stress", "bectoken"):
        assert got["must_revert"].any() and got["jumpdest"].any()


def _specs():
    return [
        dict(symbolic_calldata=True, symbolic_storage=True, symbolic_caller=True, symbolic_callvalue=True,
             symbolic_balance=True, seed_id=3, job_id=2),
        dict(calldata=bytes(range(70)), callvalue=5, caller=0xABCDEF, storage={1: 2, 1 << 200: 7}, gas=123),
        dict(calldata=b"\x01" * 96, origin=0x77, balance=0, outermost=False),
    ]


def test_build_batch_planes_match_reference():
    ref = rb.build_batch(rb.BatchConfig(**CFG), _specs())
    port = pb.build_batch(pb.BatchConfig(**CFG), _specs(), device="cpu")
    got = convert.batch_to_numpy(port)
    assert list(got) == list(rb.StateBatch._fields)
    for field in rb.StateBatch._fields:
        r = np.asarray(getattr(ref, field))
        assert r.dtype == got[field].dtype and np.array_equal(r, got[field]), field


def test_batch_shapes_and_default_config_match_reference():
    assert pb.batch_shapes(pb.BatchConfig(**CFG)) == rb.batch_shapes(rb.BatchConfig(**CFG))
    assert tuple(pb.DEFAULT_BATCH_CFG) == tuple(rbackend.DEFAULT_BATCH_CFG)
    assert pb.StateBatch._fields == rb.StateBatch._fields
    assert pb.CodeBank._fields == rb.CodeBank._fields


def test_convert_round_trip_keeps_bytes():
    ref = rb.build_batch(rb.BatchConfig(**CFG), _specs())
    planes = {k: np.asarray(v).copy() for k, v in ref._asdict().items()}
    planes["tape_h1"][:] = 0xFFFFFFFF  # high-bit u32 values survive the int32 view
    planes["gas_left"][0] = 0x80000001
    st = convert.batch_to_torch(planes, "cpu")
    back = convert.batch_to_numpy(st)
    for k, v in planes.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes(), k
    cb = rb.make_code_bank([assemble(bench.STRESS_SRC)], 512)
    cbn = {k: np.asarray(v) for k, v in cb._asdict().items()}
    cb_back = convert.code_bank_to_numpy(convert.code_bank_to_torch(cbn, "cpu"))
    for k, v in cbn.items():
        assert cb_back[k].tobytes() == v.tobytes(), k
