"""A/B of one analysis between two checkouts, on one card.

Each run is a fresh process in one checkout's root: it builds that
checkout's kernels, then runs ``SymExecWrapper(strategy="cuda-batch")`` +
``fire_lasers`` on becstress (``chip_smoke.STRESS_SRC``, 2 transactions,
the default) or BECToken (``bench_contracts/bectoken.asm``), on the fused
tier or, with ``--fused off``, the sync slice tier
(``MYTHRIL_TPU_FUSED=off``), and prints one JSON line: the issue set, the
wall, device rounds and slices, fused rounds and syncs, device steps
retired, states, K1 launches, when each ``_run_device`` call (the
warmup's first) started and how long it took, and the warmup's start
and wall. Run it from a directory that holds both checkouts, on a
machine with the card, e.g.

    python3 mythril_tpu_torch/ab_becstress.py parent_checkout . --order ABBAAB --budget 40
    python3 mythril_tpu_torch/ab_becstress.py parent_checkout . --order ABBA --budget 120 \
        --contract bectoken --tx 3 --fused off

Both checkouts must have ``chip_smoke.py`` and ``mythril_tpu_torch``.

With ``--device cpu`` the analysis runs on the CPU (every kernel wrapper
takes its plain twin) under a clock that stops during device calls, so
the execution budget, the engagement delay and the solver's remaining
time count host time as they would beside the card; with
``--engage-after-states N`` the engagement gate opens once the host has
explored N states instead of after ``device_engage_after_s``. That
replays, on any machine, the branch an analysis takes when the gate
opens at a given point of the host's exploration, e.g.

    python3 mythril_tpu_torch/ab_becstress.py . . --order A --budget 120 --contract bectoken --tx 3 \
        --fused off --device cpu --engage-after-states 80
"""

import argparse
import os
import subprocess
import sys

RUN_ONE = r'''
import json, os, sys, time
sys.path.insert(0, ".")
import chip_smoke
budget, contract, tx, fused = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4]
device, engage_states = sys.argv[5], int(sys.argv[6])
if fused == "off":
    os.environ["MYTHRIL_TPU_FUSED"] = "off"
from mythril_tpu_torch.laser.cuda import _build, backend, engine
from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.analysis.security import fire_lasers
from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
from mythril_tpu_torch.ethereum.evmcontract import EVMContract
from mythril_tpu_torch.laser.evm import svm, time_handler
from mythril_tpu_torch.obs import catalog as cat
device_s = [0.0]
if device == "cpu":
    import datetime, types
    backend.DEVICE, backend.WARMUP_ASYNC = "cpu", False
    real_time, real_monotonic = time.time, time.monotonic
    clock = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    clock.time = lambda: real_time() - device_s[0]
    clock.monotonic = lambda: real_monotonic() - device_s[0]
    class HostClock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return datetime.datetime.fromtimestamp(clock.time(), tz)
    backend.time, svm.datetime = clock, HostClock
    time_handler._now_ms = lambda: int(clock.time() * 1000)
    backend.warmup_device(backend.DEFAULT_BATCH_CFG)
else:
    _build.build_all()
if engage_states >= 0:
    lasers = []
    execute_state = svm.LaserEVM.execute_state
    def execute_state_rec(self, state):
        lasers[:] = [self]
        return execute_state(self, state)
    svm.LaserEVM.execute_state = execute_state_rec
    backend.CudaBatchStrategy.engaged = lambda self: bool(lasers) and lasers[0].total_states >= engage_states
handoff = chip_smoke.HandoffProbe() if hasattr(chip_smoke, "HandoffProbe") else None
runtime = assemble(chip_smoke.STRESS_SRC if contract == "becstress" else open("bench_contracts/bectoken.asm").read())
n = len(runtime)
creation = assemble(f"PUSH2 {n}\nPUSH2 :code\nPUSH1 0x00\nCODECOPY\nPUSH2 {n}\nPUSH1 0x00\nRETURN\ncode:").hex() + runtime.hex()
engine.launches = 0
calls, warm = [], []
run_device, do_warmup = backend._run_device, backend._do_warmup
def run_device_rec(*a, **k):
    t = time.time(); out = run_device(*a, **k); dt = time.time() - t
    calls.append((round(t - t0 - device_s[0], 3), round(dt, 3)))
    if device == "cpu":
        device_s[0] += dt
    return out
def warmup_rec(key, event):
    t = time.time(); out = do_warmup(key, event); warm.append((round(t - t0, 3), round(time.time() - t, 3))); return out
backend._run_device, backend._do_warmup = run_device_rec, warmup_rec
slices0 = cat.DEVICE_SLICES_TOTAL.value()
device_s[0] = 0.0
t0 = time.time()
if handoff is not None:
    handoff.start()
sym = SymExecWrapper(EVMContract(code=runtime.hex(), creation_code=creation, name=contract), address=0x1234,
                     strategy="cuda-batch", execution_timeout=budget, transaction_count=tx, max_depth=128)
issues = sorted({(i.swc_id, i.address) for i in fire_lasers(sym)})
if handoff is not None:
    handoff.stop()
s = backend.find_tpu_strategy(sym.laser.strategy)
print(json.dumps({"contract": contract, "tx": tx, "fused": fused, "device": device,
                  "engage_after_states": engage_states, "handoff": handoff.at if handoff else None,
                  "issues": issues, "wall_s": round(time.time() - t0, 3), "device_s": round(device_s[0], 3),
                  "device_rounds": s.device_rounds,
                  "device_slices": cat.DEVICE_SLICES_TOTAL.value() - slices0,
                  "fused_rounds": s.fused_rounds, "fused_syncs": s.fused_syncs,
                  "steps": s.device_steps_retired, "states": sym.laser.total_states, "K1": engine.launches,
                  "run_device_calls_start_wall_s": calls, "warmup_start_wall_s": warm}))
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", help="checkout A (root directory)")
    ap.add_argument("b", help="checkout B (root directory)")
    ap.add_argument("--order", default="ABBAAB", help="the runs, in turns, e.g. ABBA")
    ap.add_argument("--budget", type=int, default=40, help="--execution-timeout of each analysis, s")
    ap.add_argument("--contract", choices=("becstress", "bectoken"), default="becstress")
    ap.add_argument("--tx", type=int, default=2, help="transaction count")
    ap.add_argument("--fused", choices=("on", "off"), default="on", help="off: the sync slice tier")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the plain twins, under a clock that stops during device calls")
    ap.add_argument("--engage-after-states", type=int, default=-1,
                    help="open the engagement gate once the host has explored this many states")
    args = ap.parse_args(argv)
    trees = {"A": args.a, "B": args.b}
    for tag in args.order:
        p = subprocess.run([sys.executable, "-c", RUN_ONE, str(args.budget), args.contract, str(args.tx), args.fused,
                            args.device, str(args.engage_after_states)],
                           cwd=os.path.abspath(trees[tag]),
                           capture_output=True, text=True,
                           timeout=args.budget + (600 if args.device == "cuda" else 3000))
        line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else p.stderr[-2000:]
        print(tag, trees[tag], line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
