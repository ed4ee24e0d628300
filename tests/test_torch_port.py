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


def test_entry_points_raise_without_cuda_by_default(monkeypatch):
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
