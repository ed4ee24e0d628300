"""The port's boundaries: mythril_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package, and every entry point that makes or runs
device state defaults to the card and raises where there is none, instead
of falling back to the CPU."""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mythril_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in ("jax", "jaxlib", "mythril_tpu") or m.startswith("jax.")
    ]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_entry_points_raise_without_cuda_by_default(monkeypatch, capsys):
    from mythril_tpu_torch.laser.cuda import batch, engine, inloop_solve, keccak, megakernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = batch.BatchConfig(lanes=2, stack_slots=4, memory_bytes=32, calldata_bytes=32, storage_slots=2,
                            code_len=16, tape_slots=4, path_slots=2, mem_sym_slots=2, ss_ring=2)
    code = [b"\x60\x01\x00"]
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.make_code_bank(code, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.empty_batch(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch.build_batch(cfg, [{}])
    cb = batch.make_code_bank(code, 16, device="cpu")
    st = batch.build_batch(cfg, [{}], device="cpu")
    pool = inloop_solve.empty_pool("cpu")
    data = torch.zeros((2, 8), dtype=torch.uint8)
    length = torch.zeros(2, dtype=torch.int32)
    calls = [
        lambda: engine.step(cb, None, st),
        lambda: keccak.keccak256_batch(data, length),
        lambda: inloop_solve.unsat_mask(pool, st),
        lambda: megakernel.run_fused(cb, None, st, max_rounds=1),
        lambda: inloop_solve.empty_pool(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the service's entry points: AnalysisService() on the backend's
    # default device, `serve` without --device cpu, and the command line
    # spawn_worker gives a fleet worker by default
    import subprocess

    from mythril_tpu_torch.fleet import worker
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.laser.cuda import backend
    from mythril_tpu_torch.service import AnalysisService

    assert backend.DEVICE == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        AnalysisService()
    spawned = []
    monkeypatch.setattr(subprocess, "Popen", lambda argv, **kw: spawned.append(argv))
    worker.spawn_worker("/tmp/w.sock")
    (argv,) = spawned
    assert argv[1:3] == ["-m", "mythril_tpu_torch"] and argv[argv.index("--device") + 1] == "cuda"
    for cmd in (["serve"], argv[3:]):
        with pytest.raises(SystemExit) as e:
            cli.main(cmd)
        assert e.value.code == 1 and backend.DEVICE == "cuda"
        assert "CUDA is not available" in capsys.readouterr().err
    # with device="cpu" the same calls run the plain twins
    out = megakernel.run_fused(cb, None, st, max_rounds=1, steps_per_round=4, device="cpu")
    assert int(out.info[0]) == 1 and int(out.st.steps[0]) == 2  # PUSH1, STOP
    assert np.array_equal(keccak.keccak256_batch(data, length, device="cpu")[0].numpy(),
                          np.frombuffer(bytes.fromhex(
                              "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"), np.uint8))


def test_kernel_plane_table_matches_statebatch():
    """csrc/common.cuh's Field enum must list StateBatch._fields in order."""
    from mythril_tpu_torch.laser.cuda.batch import StateBatch

    src = open(os.path.join(PORT, "csrc", "common.cuh")).read()
    body = src[src.index("enum Field {") + len("enum Field {"): src.index("NFIELDS")]
    names = [n.strip()[2:].lower() for n in body.replace("\n", " ").split(",") if n.strip()]
    assert names == list(StateBatch._fields)


# A stand-in for an A/B script's RUN_ONE: prints the digest and ok flag
# that its checkout's files hold, or fails where the checkout says so.
_AB_RUN_ONE = r"""
import json, os, sys
if os.path.exists("fail"):
    sys.exit(3)
print("noise")
print(json.dumps({"ok": not os.path.exists("not_ok"), "arg": sys.argv[1],
                  "items": {"x": {"digest": open("digest").read(), "ms": 1.0}, "y": {"ms": 2.0}}}))
"""


@pytest.mark.parametrize("case, rc", [("agree", 0), ("digests_differ", 1), ("run_fails", 1), ("not_ok", 1)])
def test_ab_main_runs_turns_and_holds_digests(tmp_path, capsys, case, rc):
    """The A/B scripts' shared driver: each turn in its checkout, in the
    order given; a failed run, an ok of false or digests that differ
    between the runs fail it."""
    import json

    from mythril_tpu_torch.ab import ab_main

    for key in "AB":
        (tmp_path / key).mkdir()
        (tmp_path / key / "digest").write_text("d" if case != "digests_differ" or key == "A" else "e")
    if case == "run_fails":
        (tmp_path / "B" / "fail").write_text("")
    if case == "not_ok":
        (tmp_path / "A" / "not_ok").write_text("")

    def options(ap):
        ap.add_argument("--n", type=int, default=4)

    got = ab_main("doc", _AB_RUN_ONE, lambda a: (a.n,), options,
                  [str(tmp_path / "A"), str(tmp_path / "B"), "--order", "ABBA", "--n", "7"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert got == rc
    runs = lines[:4]
    assert [r["tree"] for r in runs] == list("ABBA") and [r["run"] for r in runs] == [0, 1, 2, 3]
    for r in runs:
        if case == "run_fails" and r["tree"] == "B":
            assert r["rc"] == 3
        else:
            assert r["arg"] == "7" and r["path"] == str(tmp_path / r["tree"])
    assert lines[4] == {"outputs_agree": case != "digests_differ", "differ": ["x"] if case == "digests_differ" else []}


# -- no host sync inside the device loops ------------------------------------

# The loops that queue a super-round on the card: the bodies of every loop
# of these functions, and these methods whole (the cross-card exchange's
# steps, which the loop calls each round). A host read there would pin a
# sync into every round (the reference lints its fused loops the same way,
# scripts/lint.py's device_loop_purity).
_LOOP_FUNCTIONS = {
    "laser/cuda/megakernel.py": ("run_fused", "run_fused_mesh", "_run_fused_mesh_cards"),
}
_WHOLE_FUNCTIONS = {
    "laser/cuda/mesh.py": ("steal_round", "CardExchange.start", "CardExchange.count", "CardExchange.plan",
                           "CardExchange.pull", "CardExchange.steal_round", "CardExchange._wait",
                           "CardExchange._record", "CardExchange._launch"),
    "laser/cuda/kernels.py": ("launch_mesh_cards",),
}
_HOST_READS = {"item", "cpu", "tolist", "numpy", "synchronize"}
_COERCIONS = {"bool", "int", "float"}


def _host_syncs(nodes, lines):
    """(line, what) of every host read in ``nodes``: ``.item()``,
    ``.cpu()``, ``.tolist()``, ``.numpy()``, any ``.synchronize()``
    (torch.cuda's, an event's, a stream's), and ``bool()``, ``int()`` or
    ``float()`` of anything but a literal. A line marked ``noqa`` is
    exempt, as in scripts/lint.py."""
    out = []
    for node in nodes:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call) or "noqa" in lines[sub.lineno - 1]:
                continue
            fn = sub.func
            if isinstance(fn, ast.Attribute) and fn.attr in _HOST_READS:
                out.append((sub.lineno, f".{fn.attr}()"))
            elif isinstance(fn, ast.Name) and fn.id in _COERCIONS and not all(
                    isinstance(a, ast.Constant) for a in sub.args):
                out.append((sub.lineno, f"{fn.id}()"))
    return out


def _functions(tree):
    """{name or Class.name: FunctionDef} of a module's top level."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def _loop_syncs(rel, loops_only, names):
    src = open(os.path.join(PORT, rel)).read()
    lines = src.splitlines()
    fns = _functions(ast.parse(src))
    missing = [n for n in names if n not in fns]
    assert not missing, f"{rel} has no {missing}"
    found = []
    for name in names:
        fn = fns[name]
        nodes = [n for n in ast.walk(fn) if isinstance(n, (ast.For, ast.While))] if loops_only else [fn]
        if loops_only:
            assert nodes, f"{rel}:{name} has no loop"
            nodes = [stmt for loop in nodes for stmt in loop.body]
        found += [(f"{rel}:{line}", what) for line, what in _host_syncs(nodes, lines)]
    return found


@pytest.mark.parametrize("rel", sorted(set(_LOOP_FUNCTIONS) | set(_WHOLE_FUNCTIONS)))
def test_device_loops_make_no_host_sync(rel):
    found = _loop_syncs(rel, True, _LOOP_FUNCTIONS.get(rel, ()))
    found += _loop_syncs(rel, False, _WHOLE_FUNCTIONS.get(rel, ()))
    assert not found, f"host syncs inside the device loops: {found}"


def test_host_sync_check_finds_each_kind():
    src = """
def loop(t, ev, n):
    for _ in range(int(n)):
        a = t.item()
        b = t.cpu()
        c = t.tolist()
        d = t.numpy()
        torch.cuda.synchronize()
        ev.synchronize()
        e = bool(t.any())
        f = int(t[0])
        g = float(t.sum())
        h = int(3)
        i = int(t[1])  # noqa: a host value
"""
    lines = src.splitlines()
    fn = ast.parse(src).body[0]
    body = [stmt for loop in ast.walk(fn) if isinstance(loop, ast.For) for stmt in loop.body]
    got = [what for _line, what in _host_syncs(body, lines)]
    assert got == [".item()", ".cpu()", ".tolist()", ".numpy()", ".synchronize()", ".synchronize()", "bool()",
                   "int()", "float()"]
