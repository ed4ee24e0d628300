"""The port's whole analysis against the JAX reference's.

``SymExecWrapper(..., strategy="cuda-batch")`` + ``fire_lasers`` on the
contracts of tests/analysis/test_tpu_batch_strategy.py must report the
reference's ``(swc, address)`` issue set (the reference runs through
``tpu-batch`` at the same batch config), with the device path taken
(``device_rounds > 0``). The port runs on the CPU here: every kernel
wrapper takes its plain twin."""

import logging

import pytest

import mythril_tpu.laser.tpu.backend as ref_backend
import mythril_tpu_torch.laser.cuda.backend as port_backend
from mythril_tpu.analysis.security import fire_lasers as ref_fire_lasers
from mythril_tpu.analysis.symbolic import SymExecWrapper as RefSymExecWrapper
from mythril_tpu.disassembler.asm import assemble as ref_assemble
from mythril_tpu.ethereum.evmcontract import EVMContract as RefEVMContract
from mythril_tpu.laser.tpu.batch import BatchConfig as RefBatchConfig
from mythril_tpu_torch.analysis.security import fire_lasers
from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.ethereum.evmcontract import EVMContract
from mythril_tpu_torch.laser.cuda import solver as port_solver
from mythril_tpu_torch.laser.cuda import solver_cache as port_solver_cache
from mythril_tpu_torch.laser.cuda.batch import BatchConfig

logging.getLogger().setLevel(logging.ERROR)

# tests/analysis/test_tpu_batch_strategy.py's TEST_CFG
CFG = dict(lanes=32, stack_slots=16, memory_bytes=256, calldata_bytes=128, storage_slots=8,
           code_len=512, tape_slots=64, path_slots=16, mem_sym_slots=8)


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's test settings (the reference's live in tests/conftest.py):
    the CPU device, a small batch, the shrunk solver caps, a synchronous
    warmup and a fresh solver cache per test."""
    monkeypatch.setattr(port_backend, "DEVICE", "cpu")
    monkeypatch.setattr(port_backend, "WARMUP_ASYNC", False)
    monkeypatch.setattr(port_backend, "DEFAULT_BATCH_CFG", BatchConfig(**CFG))
    monkeypatch.setattr(port_solver, "MAX_VARS", 512)
    monkeypatch.setattr(port_solver, "MAX_CLAUSES", 2048)
    monkeypatch.setattr(ref_backend, "DEFAULT_BATCH_CFG", RefBatchConfig(**CFG))
    port_solver_cache.reset_for_tests()
    yield
    port_solver_cache.reset_for_tests()


def _creation(asm, runtime_hex):
    n = len(runtime_hex) // 2
    src = f"PUSH2 {n}\nPUSH2 :code\nPUSH1 0x00\nCODECOPY\nPUSH2 {n}\nPUSH1 0x00\nRETURN\ncode:"
    return asm(src).hex() + runtime_hex


def analyze_port(src, tx_count=1, timeout=120, max_depth=64):
    runtime = assemble(src).hex()
    contract = EVMContract(code=runtime, creation_code=_creation(assemble, runtime), name="T")
    sym = SymExecWrapper(contract, address=0x1234, strategy="cuda-batch", execution_timeout=timeout,
                         transaction_count=tx_count, max_depth=max_depth)
    issues = sorted({(i.swc_id, i.address) for i in fire_lasers(sym)})
    return issues, port_backend.find_tpu_strategy(sym.laser.strategy)


def analyze_ref(src, tx_count=1, timeout=120, max_depth=64):
    runtime = ref_assemble(src).hex()
    contract = RefEVMContract(code=runtime, creation_code=_creation(ref_assemble, runtime), name="T")
    sym = RefSymExecWrapper(contract, address=0x1234, strategy="tpu-batch", execution_timeout=timeout,
                            transaction_count=tx_count, max_depth=max_depth)
    issues = sorted({(i.swc_id, i.address) for i in ref_fire_lasers(sym)})
    return issues, ref_backend.find_tpu_strategy(sym.laser.strategy)


CONTRACTS = {
    "swc106_suicide": ("""
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
        """, "106", 120),
    "swc115_origin": ("""
        ORIGIN
        PUSH20 0xaffeaffeaffeaffeaffeaffeaffeaffeaffeaffe
        EQ
        PUSH2 :ok
        JUMPI
        STOP
        ok:
        JUMPDEST
        PUSH1 0x01
        PUSH1 0x00
        SSTORE
        STOP
        """, "115", 120),
    "swc110_assert": ("""
        PUSH1 0x00
        CALLDATALOAD
        PUSH1 0x2a
        EQ
        PUSH2 :boom
        JUMPI
        STOP
        boom:
        JUMPDEST
        ASSERT_FAIL
        """, "110", 120),
    "swc101_overflow": ("""
        PUSH1 0x04
        CALLDATALOAD
        PUSH32 0xffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff00
        ADD
        PUSH1 0x00
        SSTORE
        STOP
        """, "101", 120),
    "swc105_ether_thief": ("""
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        PUSH1 0x00
        SELFBALANCE
        PUSH1 0x04
        CALLDATALOAD
        PUSH2 0x8fc
        CALL
        POP
        STOP
        """, "105", 90),
    "clean": ("""
        CALLER
        PUSH20 0xaffeaffeaffeaffeaffeaffeaffeaffeaffeaffe
        EQ
        PUSH2 :ok
        JUMPI
        PUSH1 0x00
        PUSH1 0x00
        REVERT
        ok:
        JUMPDEST
        CALLER
        SELFDESTRUCT
        """, None, 120),
}


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_swc_issue_set_equals_reference(name):
    src, swc, timeout = CONTRACTS[name]
    ref_issues, _ = analyze_ref(src, timeout=timeout)
    port_issues, strategy = analyze_port(src, timeout=timeout)
    assert port_issues == ref_issues
    if swc is not None:
        assert swc in {s for s, _ in port_issues}
    else:
        assert "106" not in {s for s, _ in port_issues}
    if name != "swc105_ether_thief":  # the reference test asserts no device round there either
        assert strategy.device_rounds > 0


def test_inloop_solve_on_off_equivalence(monkeypatch):
    """The in-loop kill (K3) must not change the issue set
    (tests/laser/test_inloop_solve.py KILL_SRC, at its 16-lane config)."""
    monkeypatch.setattr(port_backend, "DEFAULT_BATCH_CFG", BatchConfig(**dict(CFG, lanes=16)))
    src = CONTRACTS["swc106_suicide"][0]
    results = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("MYTHRIL_TPU_INLOOP_SOLVE", flag)
        port_solver_cache.GLOBAL.reset()
        results[flag] = analyze_port(src, timeout=480)
    (off, s_off), (on, s_on) = results["0"], results["1"]
    assert on == off
    assert any(swc == "106" for swc, _ in on)
    assert s_off.in_loop_unsat_kills == 0
    assert s_on.device_rounds > 0 and s_off.device_rounds > 0
