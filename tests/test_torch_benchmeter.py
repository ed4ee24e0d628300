"""The port's copy of the steady-state meter (``support/benchmeter.py``):
the reference's four cases (tests/support/test_benchmeter.py) on the
port's SymExecWrapper, and its device probe reading the port's
CudaBatchStrategy."""

import logging

from mythril_tpu_torch.analysis.security import fire_lasers
from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.ethereum.evmcontract import EVMContract
from mythril_tpu_torch.laser.cuda.backend import CudaBatchStrategy
from mythril_tpu_torch.support.benchmeter import SteadyStateMeter, _device_steps

logging.getLogger().setLevel(logging.ERROR)

# origin-gated stop: cheap to execute, nonzero message-call state count
RUNTIME_SRC = "PUSH1 0x00\nCALLDATALOAD\nPUSH1 0x02\nADD\nPOP\nSTOP\n"


def _contract() -> EVMContract:
    runtime = assemble(RUNTIME_SRC).hex()
    n = len(runtime) // 2
    creation = (
        assemble(f"PUSH2 {n}\nPUSH2 :code\nPUSH1 0x00\nCODECOPY\nPUSH2 {n}\nPUSH1 0x00\nRETURN\ncode:").hex()
        + runtime
    )
    return EVMContract(code=runtime, creation_code=creation, name="Meter")


def _analyze(meter: SteadyStateMeter):
    sym = SymExecWrapper(_contract(), address=0x1234, strategy="bfs", execution_timeout=30, transaction_count=1,
                         max_depth=32, pre_exec_hook=meter.install)
    fire_lasers(sym)
    meter.close()
    return sym


def test_window_excludes_creation():
    meter = SteadyStateMeter()
    sym = _analyze(meter)
    assert len(meter.windows) == 1
    # creation executed instructions before the window opened, so the
    # windowed count must be strictly below the engine's total
    assert 0 < meter.states < sym.laser.total_states
    assert meter.wall > 0
    assert meter.states_per_s > 0


def test_windows_aggregate_across_runs():
    meter = SteadyStateMeter()
    _analyze(meter)
    one_run_states = meter.states
    _analyze(meter)
    assert len(meter.windows) == 2
    assert meter.states > one_run_states
    assert meter.wall >= meter.windows[0][1]


def test_close_is_idempotent_and_unopened_window_drops():
    meter = SteadyStateMeter()
    meter.close()  # nothing installed: no-op
    assert meter.windows == []
    _analyze(meter)
    n = len(meter.windows)
    meter.close()  # second close after a closed run: no new window
    assert len(meter.windows) == n


def test_device_steps_probe_plain_strategy():
    class Chain:
        super_strategy = None

    class Laser:
        strategy = Chain()
        total_states = 0

    assert _device_steps(Laser()) == 0


def test_device_steps_probe_reads_the_cuda_strategy():
    # the port's batch strategy, wrapped as the decorator chain wraps it
    strategy = CudaBatchStrategy([], max_depth=8)
    strategy.device_steps_retired = 1234

    class Outer:
        super_strategy = strategy

    class Laser:
        total_states = 0

    Laser.strategy = Outer()
    assert _device_steps(Laser()) == 1234
