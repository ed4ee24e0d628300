"""The host half the port carries over from the JAX package.

Every module of ``mythril_tpu_torch`` that has a namesake in
``mythril_tpu`` is a copy: it must equal the reference file once
``mythril_tpu`` is replaced by ``mythril_tpu_torch``, apart from the
files listed in EDITED, each with its reason and the most lines its
edit may change, and those in TEXT_EDITED, whose code (everything but
comments and docstrings) must still equal the reference's. No copy may
import jax or the reference package.

The copied degrade handlers turn most exceptions into host rounds; a
kernel failure must pass through each of them instead, whether it is a
KernelError from a wrapper or the CUDA error torch raises at the next
sync after a kernel faulted. The tests inject both on the CPU through
monkeypatched wrappers."""

import ast
import difflib
import os
import re

import pytest
import torch

import mythril_tpu_torch.laser.cuda.backend as backend
from mythril_tpu_torch.laser.cuda import _build, megakernel, solver, solver_cache
from mythril_tpu_torch.laser.cuda._build import KernelError
from mythril_tpu_torch.laser.cuda.batch import BatchConfig
from mythril_tpu_torch.robustness import retry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mythril_tpu_torch")
REF = os.path.join(ROOT, "mythril_tpu")

# relative path -> (why the code differs, most changed lines)
EDITED = {
    "analysis/symbolic.py": (
        "the strategy name cuda-batch maps to the port's CudaBatchStrategy; the comment on the solver core "
        "says the service's jobs start from a fresh one too", 15),
    "smt/solver/incremental.py": (
        "the solver core is kept per thread, so a service job (one worker thread) never queries the clause "
        "database of another job or of an earlier analysis", 25),
    "laser/evm/time_handler.py": (
        "the execution deadline is kept per thread, so a service job's solver budget is its own and not "
        "that of the job that started last", 12),
    "laser/evm/svm.py": ("the strategy probe and the lazy import point at the port's backend", 12),
    "obs/catalog.py": ("the solver-cache collector reads the port's solver_cache", 2),
    "obs/trace.py": ("parent links and profiler-clock mirroring for the port's hand-off spans", 35),
    "robustness/retry.py": ("the port's backend/transfer; a kernel fault passes the round guard", 6),
    "interfaces/cli.py": (
        "the strategy choice cuda-batch replaces tpu-batch; --lanes and the new --device {cuda,cpu} set "
        "the port's backend (no card behind --device cuda raises); main() drops the JAX compile cache "
        "and the exit check reads the port's backend; serve takes the same --device and sets the port's "
        "backend with it", 31),
    "service/lanes.py": ("the shared round packs through the port's DeviceBridge on the backend's device", 4),
    "service/scheduler.py": (
        "the port's backend, solver_cache and strategy name cuda-batch; AnalysisService() on the default "
        "device raises where there is no card; warm builds with nvcc; each job starts from a fresh solver "
        "core (its own thread's)", 18),
    "fleet/worker.py": (
        "a spawned worker runs the port's CLI (python -m mythril_tpu_torch, its checkout on PYTHONPATH) "
        "and is told its --device", 11),
}

# relative path -> why its comments or docstrings differ (its code may not)
TEXT_EDITED = {
    "support/keccak.py": "the docstring names the port's batched kernel, not the JAX one",
    "support/benchmeter.py": "the docstrings name the port's cuda-batch strategy, not the JAX one",
    "disassembler/asm.py": "the corpus the docstring names lives in the reference package",
    "analysis/static_pass/blocks.py": "the docstring names the port's code bank constructor",
    # comments that named the change which introduced the code
    "analysis/static_pass/__init__.py": "a comment named a change number",
    "analysis/static_pass/dataflow.py": "a docstring named a change number",
    "analysis/static_pass/tables.py": "a comment named a change number",
    "analysis/static_pass/taint.py": "docstrings named a change number",
    "analysis/module/gating.py": "a docstring named a change number",
    "analysis/rewrite_pass/__init__.py": "a docstring named a change number",
    "analysis/rewrite_pass/assume.py": "a docstring named a change number",
    "analysis/rewrite_pass/engine.py": "docstrings named a change number",
    "analysis/rewrite_pass/intervals.py": "a docstring named a change number",
    "obs/__init__.py": "a docstring named a change number",
    "obs/metrics.py": "a docstring named a change number",
}


def _copies():
    out = []
    for d, _dirs, files in os.walk(PORT):
        if "_build" in d or "__pycache__" in d:
            continue
        for f in files:
            if not f.endswith((".py", ".cpp")):
                continue
            rel = os.path.relpath(os.path.join(d, f), PORT)
            if rel == "__init__.py":  # the port's own package marker
                continue
            if os.path.exists(os.path.join(REF, rel)):
                out.append(rel)
    return sorted(out)


COPIES = _copies()


def _retargeted(rel):
    with open(os.path.join(REF, rel)) as fh:
        return re.sub(r"\bmythril_tpu\b", "mythril_tpu_torch", fh.read())


def test_the_host_half_is_copied():
    # the analysis path's host modules: laser/evm, smt, analysis, obs,
    # robustness, support, disassembler, ethereum and the native core
    assert len(COPIES) >= 130
    for rel in ("laser/evm/svm.py", "smt/terms.py", "analysis/symbolic.py", "csrc/native.cpp",
                "ethereum/evmcontract.py", "robustness/checkpoint.py", "obs/trace.py",
                # the CLI's closure
                "interfaces/cli.py", "interfaces/epic.py", "__main__.py", "core/mythril_analyzer.py",
                "core/mythril_disassembler.py", "core/mythril_config.py", "core/mythril_leveldb.py",
                "support/loader.py", "solidity/soliditycontract.py", "ethereum/interface/rpc/client.py",
                "ethereum/interface/leveldb/client.py", "ethereum/util.py", "ethereum/rlp.py",
                "analysis/traceexplore.py", "analysis/callgraph.py", "plugin/loader.py", "mythx/__init__.py",
                # the concolic message call, the service and the fleet
                "laser/evm/transaction/concolic.py", "service/__init__.py", "service/api.py",
                "service/cache.py", "service/lanes.py", "service/scheduler.py", "fleet/__init__.py",
                "fleet/gateway.py", "fleet/hashring.py", "fleet/ingest.py", "fleet/qos.py", "fleet/store.py",
                "fleet/transport.py", "fleet/worker.py"):
        assert rel in COPIES
    assert set(EDITED) <= set(COPIES) and set(TEXT_EDITED) <= set(COPIES)
    assert not set(EDITED) & set(TEXT_EDITED)


def _code_of(src):
    """The module's syntax tree without its docstrings (comments are not
    in the tree): what a text-only edit must leave unchanged."""
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_reference(rel):
    want = _retargeted(rel).splitlines()
    with open(os.path.join(PORT, rel)) as fh:
        got = fh.read().splitlines()
    changed = [
        ln for ln in difflib.unified_diff(want, got, lineterm="", n=0)
        if ln[:1] in "+-" and not ln.startswith(("+++", "---"))
    ]
    if rel in EDITED:
        reason, most = EDITED[rel]
        assert 0 < len(changed) <= most, f"{rel}: {len(changed)} changed lines ({reason})"
    elif rel in TEXT_EDITED:
        assert changed, f"{rel} equals its reference; drop it from TEXT_EDITED"
        assert _code_of("\n".join(got)) == _code_of("\n".join(want)), (
            f"{rel}: its code differs from the reference, not only its text ({TEXT_EDITED[rel]})")
    else:
        assert not changed, f"{rel} differs from its reference: {changed[:6]}"


@pytest.mark.parametrize("rel", [r for r in COPIES if r.endswith(".py")])
def test_copy_imports_neither_jax_nor_the_reference(rel):
    tree = ast.parse(open(os.path.join(PORT, rel)).read())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.append(node.module)
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "mythril_tpu")]
    assert not bad


# -- KernelError through the copied handlers ---------------------------


def _boom(*_a, **_k):
    raise KernelError("injected kernel failure")


CUDA_FAULT = "CUDA error: an illegal memory access was encountered"


def _cuda_fault(*_a, **_k):
    # what torch raises at the first sync or launch after a kernel faulted
    raise RuntimeError(CUDA_FAULT)


# both ways a kernel failure reaches a handler: from a wrapper, or from
# torch at a later sync
FAILURES = (_boom, _cuda_fault)


class _FaultyTensor:
    """A device result whose read reports an earlier kernel's fault."""

    def detach(self):
        return self

    def cpu(self):
        raise RuntimeError(CUDA_FAULT)


@pytest.fixture
def port_cpu(monkeypatch):
    monkeypatch.setattr(backend, "DEVICE", "cpu")
    monkeypatch.setattr(backend, "WARMUP_ASYNC", False)
    monkeypatch.setattr(solver, "MAX_VARS", 512)
    monkeypatch.setattr(solver, "MAX_CLAUSES", 2048)
    solver_cache.reset_for_tests()
    retry.BREAKER.reset()
    yield
    solver_cache.reset_for_tests()
    retry.BREAKER.reset()


class _Bridge:
    fused_round_info = None
    mesh_n_shards = 1

    def finish(self):
        return None, None


def test_round_guard_reraises_kernel_error(port_cpu, monkeypatch):
    for fail in FAILURES:
        monkeypatch.setattr(backend, "_run_device", fail)
        slept = []
        with pytest.raises(KernelError):
            retry.run_round_guarded(_Bridge(), BatchConfig(), sleep=slept.append, fused_k=1)
        assert slept == []  # no retry
        assert retry.BREAKER.state() == "closed"  # and no breaker failure


def test_device_feasibility_reraises_kernel_error(port_cpu, monkeypatch):
    """From the K5 wrapper, or from the solver's one read-back, where a
    fault inside K5 shows: decide_batch must not degrade it to the host."""
    from mythril_tpu_torch.smt import terms

    x = terms.bv_var("ke_x", 8)
    sets = [[terms.bool_eq(x, terms.bv_const(i, 8))] for i in range(8)]
    for solve in (*FAILURES, lambda *a, **k: (_FaultyTensor(), _FaultyTensor(), None)):
        monkeypatch.setattr(solver, "solve", solve)
        with pytest.raises(KernelError):
            solver_cache.GLOBAL.decide_batch(sets, use_device=True, flips=64, device="cpu")


class _State:
    def get_annotations(self, _cls):
        return []


class _Module:
    def __init__(self, collect=None, seed=None):
        self._collect, self._seed = collect, seed

    def batch_prescreen_requests(self, state, skip):
        if self._collect:
            self._collect()
        return [(("tok", i), []) for i in range(backend.MIN_DEVICE_SOLVE_BATCH)]

    def seed_prescreen(self, token, verdict):
        if self._seed:
            self._seed()


@pytest.mark.parametrize("where", ["collect", "decide", "seed"])
def test_lazy_screen_triage_reraises_kernel_error(port_cpu, monkeypatch, where):
    from mythril_tpu_torch.analysis.module import loader

    monkeypatch.setattr(backend, "_warmup_done", {"warm"})
    for fail in FAILURES:
        module = _Module(collect=fail if where == "collect" else None,
                         seed=fail if where == "seed" else None)
        monkeypatch.setattr(loader.ModuleLoader, "get_detection_modules", lambda self, *a, **k: [module])
        monkeypatch.setattr(backend, "_TRIAGE_STRIKES", [0])
        decide = fail if where == "decide" else (lambda sets, **k: [True] * len(sets))
        monkeypatch.setattr(solver_cache.GLOBAL, "decide_batch", decide)
        with pytest.raises(KernelError):
            backend._triage_lazy_screens([_State()])


def test_warmup_records_and_reraises_kernel_error(port_cpu, monkeypatch):
    cfg = BatchConfig(lanes=4, stack_slots=4, memory_bytes=32, calldata_bytes=32, storage_slots=2,
                      code_len=16, tape_slots=16, path_slots=4, mem_sym_slots=2, ss_ring=4)
    for fail in FAILURES:
        monkeypatch.setattr(backend, "_run_device", fail)
        monkeypatch.setattr(backend, "_warmup_events", {})
        monkeypatch.setattr(backend, "_warmup_errors", {})
        with pytest.raises(KernelError):
            backend.warmup_device(cfg)
        assert not backend.device_ready(cfg)
        # the analysis thread sees it (what exec_batch checks before a round)
        with pytest.raises(KernelError):
            backend._raise_warmup_error(cfg)


def _analyze_on_the_device(monkeypatch, fault):
    """A one-transaction analysis whose fork reaches a device round, with
    ``fault(monkeypatch)`` injected after the warmup."""
    from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
    from mythril_tpu_torch.disassembler.asm import assemble
    from mythril_tpu_torch.ethereum.evmcontract import EVMContract

    cfg = BatchConfig(lanes=16, stack_slots=16, memory_bytes=256, calldata_bytes=128, storage_slots=8,
                      code_len=512, tape_slots=64, path_slots=16, mem_sym_slots=8)
    monkeypatch.setattr(backend, "DEFAULT_BATCH_CFG", cfg)
    backend.warmup_device(cfg)
    assert backend.device_ready(cfg)
    fault(monkeypatch)
    runtime = assemble("PUSH1 0x00\nCALLDATALOAD\nPUSH2 :a\nJUMPI\nSTOP\na:\nJUMPDEST\nCALLER\nSELFDESTRUCT").hex()
    n = len(runtime) // 2
    creation = assemble(
        f"PUSH2 {n}\nPUSH2 :code\nPUSH1 0x00\nCODECOPY\nPUSH2 {n}\nPUSH1 0x00\nRETURN\ncode:"
    ).hex() + runtime
    contract = EVMContract(code=runtime, creation_code=creation, name="T")
    SymExecWrapper(contract, address=0x1234, strategy="cuda-batch", execution_timeout=60,
                   transaction_count=1, max_depth=64)


def test_analysis_raises_kernel_error_out_of_a_round(port_cpu, monkeypatch):
    """A kernel that fails inside a device round ends the analysis with
    KernelError; nothing turns it into host rounds."""
    with pytest.raises(KernelError):
        _analyze_on_the_device(monkeypatch, lambda mp: mp.setattr(megakernel, "run_fused", _boom))
    assert retry.BREAKER.state() == "closed"


def test_analysis_raises_a_fault_met_at_the_round_read_back(port_cpu, monkeypatch):
    """A kernel fault that CUDA reports only at the fused round's one
    blocking fetch ends the analysis with KernelError."""
    decode = megakernel.decode_info
    fetched = []

    def faulty_decode(info):
        fetched.append(info)
        return decode(_FaultyTensor())

    with pytest.raises(KernelError):
        _analyze_on_the_device(monkeypatch, lambda mp: mp.setattr(megakernel, "decode_info", faulty_decode))
    assert fetched  # the fault came from a device round's read-back
    assert retry.BREAKER.state() == "closed"


@pytest.mark.parametrize("exc, fault", [
    (KernelError("build"), True),
    (RuntimeError(CUDA_FAULT), True),
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (RuntimeError("CUDA kernel errors might be asynchronously reported at some other API call"), True),
    (RuntimeError("CUDA error: out of memory"), False),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), False),
    (RuntimeError("shape mismatch"), False),
    (ValueError("CUDA error: not a runtime error"), False),
])
def test_as_kernel_error_tells_kernel_faults_from_the_rest(exc, fault):
    err = _build.as_kernel_error(exc)
    assert (err is not None) == fault
    if fault:
        assert isinstance(err, KernelError)
        assert err is exc or err.__cause__ is exc


def test_sync_points_raise_kernel_error():
    with pytest.raises(KernelError):
        megakernel.decode_info(_FaultyTensor())
    with pytest.raises(ValueError):  # anything else passes through as it was
        with _build.sync_point():
            raise ValueError("not a device fault")
