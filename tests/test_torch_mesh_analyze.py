"""The port's whole analysis over a mesh of 8 lane shards, on the CPU.

The reference's tests/laser/test_mesh_exec_batch.py runs exec_batch
lane-sharded over 8 virtual CPU devices and expects SWC-106 with device
rounds. Here ``mesh.n_devices`` says 8 (as tests/conftest.py gives the
reference 8 virtual devices) and ``MYTHRIL_TPU_MESH`` forces the mesh:
on the fused mesh tier and on the sync mesh tier, the port must report
the reference's issue set (the reference runs with its mesh on, at the
same config) from device rounds that went through the mesh, and the
guarded round's per-shard download (``mesh_n_shards`` = 8) must bring
back what a full download does."""

import functools
import logging

import numpy as np
import pytest

import mythril_tpu.laser.tpu.backend as ref_backend
import mythril_tpu_torch.laser.cuda.backend as port_backend
from mythril_tpu.analysis.module.util import reset_callback_modules as ref_reset_callback_modules
from mythril_tpu.analysis.security import fire_lasers as ref_fire_lasers
from mythril_tpu.analysis.symbolic import SymExecWrapper as RefSymExecWrapper
from mythril_tpu.disassembler.asm import assemble as ref_assemble
from mythril_tpu.ethereum.evmcontract import EVMContract as RefEVMContract
from mythril_tpu.laser.tpu.batch import BatchConfig as RefBatchConfig
from mythril_tpu_torch.analysis.module.util import reset_callback_modules as port_reset_callback_modules
from mythril_tpu_torch.analysis.security import fire_lasers
from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.ethereum.evmcontract import EVMContract
from mythril_tpu_torch.laser.cuda import megakernel, mesh
from mythril_tpu_torch.laser.cuda import solver as port_solver
from mythril_tpu_torch.laser.cuda import solver_cache as port_solver_cache
from mythril_tpu_torch.laser.cuda import transfer as port_transfer
from mythril_tpu_torch.laser.cuda.batch import BatchConfig
from mythril_tpu_torch.robustness import retry as port_retry

logging.getLogger().setLevel(logging.ERROR)

# tests/laser/test_mesh_exec_batch.py's MESH_CFG
MESH_CFG = dict(lanes=16, stack_slots=16, memory_bytes=256, calldata_bytes=128, storage_slots=8,
                code_len=512, tape_slots=64, path_slots=16, mem_sym_slots=8)
RUNTIME = """
    PUSH1 0x00
    CALLDATALOAD
    PUSH1 0xe0
    SHR
    PUSH4 0xdeadbeef
    EQ
    PUSH2 :kill
    JUMPI
    STOP
    kill:
    JUMPDEST
    CALLER
    SELFDESTRUCT
"""


@pytest.fixture(autouse=True)
def port_mesh_on_cpu(monkeypatch):
    """The port on the CPU twins, at the reference test's config, with 8
    shards and the mesh forced on."""
    monkeypatch.setattr(port_backend, "DEVICE", "cpu")
    monkeypatch.setattr(port_backend, "WARMUP_ASYNC", False)
    monkeypatch.setattr(port_backend, "DEFAULT_BATCH_CFG", BatchConfig(**MESH_CFG))
    monkeypatch.setattr(port_backend, "MESH_MODE", "on")
    monkeypatch.setattr(mesh, "n_devices", lambda device="cuda": 8)
    monkeypatch.setattr(port_solver, "MAX_VARS", 512)
    monkeypatch.setattr(port_solver, "MAX_CLAUSES", 2048)
    monkeypatch.delenv("MYTHRIL_TPU_MESH", raising=False)
    monkeypatch.delenv("MYTHRIL_TPU_FUSED", raising=False)
    port_solver_cache.reset_for_tests()
    yield
    port_solver_cache.reset_for_tests()


def _creation(asm, runtime_hex):
    n = len(runtime_hex) // 2
    src = f"PUSH2 {n}\nPUSH2 :code\nPUSH1 0x00\nCODECOPY\nPUSH2 {n}\nPUSH1 0x00\nRETURN\ncode:"
    return asm(src).hex() + runtime_hex


def _analyze(package):
    if package == "port":
        asm, contract_cls, wrapper, fire, strategy = assemble, EVMContract, SymExecWrapper, fire_lasers, "cuda-batch"
        backend, reset = port_backend, port_reset_callback_modules
    else:
        asm, contract_cls, wrapper, fire, strategy = (ref_assemble, RefEVMContract, RefSymExecWrapper,
                                                      ref_fire_lasers, "tpu-batch")
        backend, reset = ref_backend, ref_reset_callback_modules
    # the detection modules are process-wide, and fire_lasers drains only
    # the modules it is asked for: start from empty issue records, so an
    # earlier analysis in this process cannot add its issues to this one's
    reset()
    runtime = asm(RUNTIME).hex()
    contract = contract_cls(code=runtime, creation_code=_creation(asm, runtime), name="T")
    sym = wrapper(contract, address=0x1234, strategy=strategy, execution_timeout=480, transaction_count=1,
                  max_depth=64)
    issues = sorted({(i.swc_id, i.address) for i in fire(sym)})
    return issues, backend.find_tpu_strategy(sym.laser.strategy)


@functools.lru_cache(maxsize=None)
def _ref_issues():
    """The reference's own mesh-on run (test_mesh_exec_batch.py's setup)."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ref_backend, "MESH_MODE", "on")
        mp.setattr(ref_backend, "DEFAULT_BATCH_CFG", RefBatchConfig(**MESH_CFG))
        return _analyze("ref")[0]
    finally:
        mp.undo()


@pytest.mark.parametrize("tier", ["fused", "sync"])
def test_exec_batch_runs_over_8_shards(monkeypatch, tier):
    calls = {"fused_mesh": 0, "sharded_round": 0, "n_shards": set()}
    run_fused_mesh, sharded_round = megakernel.run_fused_mesh, mesh.sharded_round

    def fused_rec(m, *a, **k):
        calls["fused_mesh"] += 1
        calls["n_shards"].add(m.n)
        return run_fused_mesh(m, *a, **k)

    def sync_rec(*a, **k):
        calls["sharded_round"] += 1
        calls["n_shards"].add(k["n_shards"])
        return sharded_round(*a, **k)

    monkeypatch.setattr(megakernel, "run_fused_mesh", fused_rec)
    monkeypatch.setattr(mesh, "sharded_round", sync_rec)
    if tier == "sync":
        monkeypatch.setenv("MYTHRIL_TPU_MESH", "sync")
    want = _ref_issues()
    issues, strategy = _analyze("port")
    assert "106" in {swc for swc, _ in issues}
    assert issues == want
    assert strategy.device_rounds > 0 and strategy.degraded_rounds == 0
    assert calls["n_shards"] == {8}
    if tier == "fused":
        assert calls["fused_mesh"] > 0 and calls["sharded_round"] == 0
        assert strategy.fused_rounds > 0 and len(strategy.mesh_occupancy) == 8
    else:
        assert calls["sharded_round"] > 0 and calls["fused_mesh"] == 0
        assert strategy.fused_rounds == 0


def test_retry_download_per_shard_round_trips(monkeypatch):
    """The guarded round downloads with the bridge's mesh_n_shards (8):
    every lane the host reads (the alive ones) and every small plane come
    back as a full-height download brings them."""
    seen = []
    batch_to_host = port_transfer.batch_to_host

    def down_rec(st, n_shards=1):
        out = batch_to_host(st, n_shards=n_shards)
        full = batch_to_host(st)
        alive = np.asarray(full.alive)
        for name, a, b in zip(type(full)._fields, out, full):
            if name in port_transfer._BIG_DOWN:
                assert np.array_equal(a[alive], b[alive]), name
            else:
                assert np.array_equal(a, b), name
        seen.append((n_shards, int(alive.sum())))
        return out

    monkeypatch.setattr(port_transfer, "batch_to_host", down_rec)
    guarded = port_retry.run_round_guarded
    rounds = []
    monkeypatch.setattr(port_retry, "run_round_guarded", lambda *a, **k: rounds.append(1) or guarded(*a, **k))
    issues, strategy = _analyze("port")
    assert "106" in {swc for swc, _ in issues}
    assert rounds and strategy.device_rounds > 0
    assert any(n == 8 and alive > 0 for n, alive in seen)
