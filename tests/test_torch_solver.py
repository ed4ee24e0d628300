"""The batched CNF solver (K5) against the JAX reference's solver_jax.

The same constraint sets, built with the reference's SMT front end and
mirrored node for node into the port's term DAG, must compile to the
same clause arrays. The decider's phase 1 (unit propagation, no
decisions) must give the reference's status and fixpoint bit for bit;
with a flip budget every SAT assignment must satisfy its CNF and UNSAT
may appear only where the reference's phase 1 says UNSAT (phase 2 draws
other random bits than jax). K5's source, compiled as host C++, must
equal the plain twin bit for bit."""

import ctypes
import random

import numpy as np
import pytest
import torch

from mythril_tpu.laser.tpu import solver_jax as ref_solver
from mythril_tpu.smt import Not, Or, UGT, ULT, symbol_factory
from mythril_tpu_torch.laser.cuda import _build, convert
from mythril_tpu_torch.laser.cuda import solver as port_solver
from mythril_tpu_torch.smt import terms as port_terms

W = 16  # small words keep the CPU-hosted kernels fast


@pytest.fixture(autouse=True)
def port_caps(monkeypatch):
    """The port's solver under the caps tests/conftest.py gives the
    reference (MAX_VARS=512, MAX_CLAUSES=2048); both packages' dispatched
    shape sets restored afterwards."""
    monkeypatch.setattr(port_solver, "MAX_VARS", ref_solver.MAX_VARS)
    monkeypatch.setattr(port_solver, "MAX_CLAUSES", ref_solver.MAX_CLAUSES)
    # dispatches here must not steer later tests' bucket choice
    monkeypatch.setattr(ref_solver, "_compiled_shapes", set(ref_solver._compiled_shapes))
    monkeypatch.setattr(port_solver, "_compiled_shapes", set(port_solver._compiled_shapes))


def mirror_sets(sets):
    """Rebuild reference terms in the port's term DAG, node for node (op,
    sort, size, args, params), creating nodes in the reference's uid
    order so that both packages sort the sets alike."""
    nodes = {}

    def collect(t):
        if t.uid not in nodes:
            nodes[t.uid] = t
            for a in t.args:
                collect(a)

    for cs in sets:
        for t in cs:
            collect(t)
    memo = {}
    for uid in sorted(nodes):
        t = nodes[uid]
        memo[uid] = port_terms._mk(t.op, t.sort, t.size, tuple(memo[a.uid] for a in t.args), t.params)
    return [[memo[t.uid] for t in cs] for cs in sets]


def sibling_sets(tag: str, seed: int, n_parents=6, n_children=3):
    """Constraint sets shaped like a frontier: siblings share a parent
    prefix and add one or two guards of their own."""
    rng = random.Random(seed)
    a, b, c = (symbol_factory.BitVecSym(f"{tag}_{n}", W) for n in "abc")

    def val(v):
        return symbol_factory.BitVecVal(v % (1 << W), W)

    sets = []
    for k in range(n_parents):
        base = [a + val(k) == b, ULT(a, val(1000 + 37 * k))]
        for _ in range(n_children):
            pick = rng.sample(
                [
                    UGT(b, val(rng.randrange(1 << W))),
                    a * val(3) == c,
                    b - a == c,
                    Or(a == val(5), b == val(rng.randrange(1 << W))),
                    Not(c == val(9)),
                    a & val(0xFF) == val(rng.randrange(256)),
                    c == val(rng.randrange(1 << W)),
                ],
                rng.randrange(1, 4),
            )
            sets.append([t.raw for t in base + pick])
    t, f = symbol_factory.Bool(True).raw, symbol_factory.Bool(False).raw
    sets += [[t], [f], [t, f], []]
    return sets


def _same_instance(r, p):
    if r is None or p is None:
        return r is None and p is None
    return (
        r.trivial == p.trivial
        and r.nvars == p.nvars
        and r.inputs == p.inputs
        and np.array_equal(r.clause_arr, p.clause_arr)
        and r.var_bits == p.var_bits
        and r.bool_vars == p.bool_vars
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compile_cnf_batch_clause_arrays_equal_reference(seed):
    sets = sibling_sets(f"cnf{seed}", seed)
    psets = mirror_sets(sets)
    ref = ref_solver.compile_cnf_batch(sets, ref_solver.MAX_VARS, ref_solver.MAX_CLAUSES)
    port = port_solver.compile_cnf_batch(psets, port_solver.MAX_VARS, port_solver.MAX_CLAUSES)
    assert [_same_instance(r, p) for r, p in zip(ref, port)] == [True] * len(sets)
    # and one set at a time (no shared-prefix trie)
    for cs, pcs in zip(sets[:6], psets[:6]):
        assert _same_instance(ref_solver.compile_cnf(cs), port_solver.compile_cnf(pcs))


def _packed(seed: int):
    """One ladder bucket's operands from compiled frontier sets: the
    reference's _pack_batch output and a warm plane of random hints."""
    sets = sibling_sets(f"pk{seed}", seed + 10)
    insts = [
        i for i in ref_solver.compile_cnf_batch(sets, ref_solver.MAX_VARS, ref_solver.MAX_CLAUSES)
        if i is not None and i.trivial is None
    ][:8]
    V, C = ref_solver._select_bucket(
        max(i.nvars for i in insts), max(i.clause_arr.shape[0] for i in insts)
    )
    lits, nvars, is_input, V = ref_solver._pack_batch(insts, V, C)
    rng = np.random.default_rng(seed)
    warm = np.where(rng.random(is_input.shape) < 0.2, rng.choice([-1, 1], is_input.shape), 0).astype(np.int8)
    return lits, nvars, is_input, warm, V


def _random_cnf(seed: int, I=8, V=64, C=160):
    """Random 1..3-literal clauses over a prefix of the vars: mostly
    propagation conflicts and open instances, the other corner."""
    rng = np.random.default_rng(seed)
    lits = np.zeros((I, C, 3), np.int32)
    nvars = rng.integers(5, V + 1, I).astype(np.int32)
    for i in range(I):
        nc = int(rng.integers(1, C + 1))
        width = rng.integers(1, 4, nc)
        picks = rng.integers(1, nvars[i] + 1, (nc, 3)) * np.where(rng.random((nc, 3)) < 0.5, 1, -1)
        for k in range(3):
            lits[i, :nc, k] = np.where(width > k, picks[:, k], 0)
    is_input = (np.arange(V)[None, :] < nvars[:, None]) & (rng.random((I, V)) < 0.3)
    warm = np.where(rng.random((I, V)) < 0.3, rng.choice([-1, 1], (I, V)), 0).astype(np.int8)
    return lits, nvars, is_input, warm, V


_CASES = [("frontier", s) for s in range(3)] + [("random", s) for s in range(4)]


def _case(kind, seed):
    return _packed(seed) if kind == "frontier" else _random_cnf(seed)


def _ref_solve(lits, nvars, is_input, warm, V, flips):
    import jax

    k = jax.jit(ref_solver._solve_kernel, static_argnums=(5, 6))
    status, assign = k(lits, jax.random.PRNGKey(0), nvars, is_input, warm, V, flips)
    return np.asarray(status), np.asarray(assign)


def _twin(lits, nvars, is_input, warm, flips, seed=1):
    ops = convert.solver_operands_to_torch((lits, nvars, is_input, warm), "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(convert.solver_operands_to_numpy(ops),
                                                    (lits, nvars, is_input, warm)))
    st, asg, sw = port_solver.solve(*ops, flips, seed, device="cpu")
    return st.numpy(), asg.numpy(), sw.numpy()


@pytest.mark.parametrize("kind,seed", _CASES)
def test_phase1_status_and_fixpoint_equal_reference(kind, seed):
    lits, nvars, is_input, warm, V = _case(kind, seed)
    zero = np.zeros_like(warm)
    ref_st, ref_asg = _ref_solve(lits, nvars, is_input, zero, V, 0)
    st, asg, _ = _twin(lits, nvars, is_input, zero, 0)
    assert np.array_equal(st, ref_st)
    # the fixpoint is unique where propagation did not conflict
    live = ref_st != ref_solver.UNSAT
    assert np.array_equal(asg[live], ref_asg[live])


def _satisfies(lits_row, assign_row) -> bool:
    for clause in lits_row:
        lits = [int(x) for x in clause if x]
        if lits and not any((x > 0) == bool(assign_row[abs(x) - 1]) for x in lits):
            return False
    return True


@pytest.mark.parametrize("kind,seed", _CASES)
@pytest.mark.parametrize("flips", [64, 4096])
def test_search_verdicts_are_sound(kind, seed, flips):
    lits, nvars, is_input, warm, V = _case(kind, seed)
    ref_st, _ = _ref_solve(lits, nvars, is_input, np.zeros_like(warm), V, 0)
    st, asg, sweeps = _twin(lits, nvars, is_input, warm, flips, seed=seed + 3)
    for i in range(len(st)):
        if st[i] == port_solver.SAT:
            assert _satisfies(lits[i], asg[i]), i
        if st[i] == port_solver.UNSAT:
            assert ref_st[i] == ref_solver.UNSAT, i
        if ref_st[i] != ref_solver.UNKNOWN:  # phase 1 decided: no search step
            assert st[i] == ref_st[i]
    assert (sweeps >= 1).all() and (sweeps <= flips + 2 * V + 2).all()


def _emu_solve(lits, nvars, is_input, warm, flips, seed, nthreads, reverse):
    """K5's source on the host: each instance's block of ``nthreads``
    threads, its parts run thread by thread in ascending or descending
    order between its barriers (csrc/host_emu.cpp ``emu_solve``)."""
    lib = _build.host_emulation()
    fn = lib.emu_solve
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_uint32, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    I, C, _ = lits.shape
    V = is_input.shape[1]
    lits, nvars = np.ascontiguousarray(lits), np.ascontiguousarray(nvars)
    is_input, warm = np.ascontiguousarray(is_input), np.ascontiguousarray(warm)
    st = np.full(I, -7, np.int32)
    asg = np.full((I, V), 0xA5, np.uint8)
    sw = np.full(I, -7, np.int32)
    assert fn(*(a.ctypes.data for a in (lits, nvars, is_input, warm, st, asg, sw)), I, C, V, flips, seed,
              nthreads, reverse) == 0
    assert set(np.unique(asg)) <= {0, 1}
    return st, asg.astype(bool), sw


# the emulated blocks: one warp (several load chunks at every bucket
# here), three warps, eight warps (one chunk for the random cases)
EMU_THREADS = (32, 96, 256)


@pytest.mark.parametrize("kind,seed", _CASES)
@pytest.mark.parametrize("flips", [0, 64])
def test_kernel_source_equals_twin(kind, seed, flips):
    lits, nvars, is_input, warm, _V = _case(kind, seed)
    twin = _twin(lits, nvars, is_input, warm, flips, seed=seed + 11)
    for nthreads in EMU_THREADS:
        for reverse in (0, 1):
            emu = _emu_solve(lits, nvars, is_input, warm, flips, seed + 11, nthreads, reverse)
            for name, t, e in zip(("status", "assign", "sweeps"), twin, emu):
                assert np.array_equal(t, e), (name, nthreads, reverse)


@pytest.mark.parametrize("nthreads", EMU_THREADS)
def test_kernel_source_literal_clamp_and_ragged_rows(nthreads):
    """Literals past the vars (the twin clamps their index to V - 1),
    clause counts that are not a multiple of 4 (the 4-byte copies) and
    an empty clause list, against the twin."""
    lits, nvars, is_input, warm, V = _random_cnf(7, I=8, V=64, C=157)
    lits = lits.copy()
    lits[0, :5, 0] = [65, -65, 1000, -(1 << 31), (1 << 31) - 1]
    lits[1, :2, :] = [[64, 0, 0], [-64, 0, 0]]
    for L in (lits, lits[:, :0].copy()):
        twin = _twin(L, nvars, is_input, warm, 64, seed=3)
        for reverse in (0, 1):
            emu = _emu_solve(L, nvars, is_input, warm, 64, 3, nthreads, reverse)
            for name, t, e in zip(("status", "assign", "sweeps"), twin, emu):
                assert np.array_equal(t, e), (name, L.shape, reverse)


def test_phase_bits_match_kernel_mix():
    """The twin's int64 mix equals the C mix (uint32 wraparound)."""
    def mix(seed, inst, step):
        m = 0xFFFFFFFF
        h = (seed * 0x9E3779B1 + inst * 0x85EBCA77 + step * 0xC2B2AE3D) & m
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & m
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & m
        h ^= h >> 16
        return h & 1

    inst = torch.arange(64, dtype=torch.int64)
    for seed, step in ((1, 0), (0xFFFFFFFF, 7), (123456789, 4095)):
        got = port_solver.phase_bits(seed, inst, step).tolist()
        assert got == [bool(mix(seed, i, step)) for i in range(64)]


def test_check_batch_end_to_end_on_cpu():
    """check_batch/feasibility_batch through the upload and the twin:
    decided verdicts agree with the reference's on mirrored sets."""
    sets = sibling_sets("cb", 5)
    psets = mirror_sets(sets)
    ref = ref_solver.check_batch(sets, flips=0)
    port = port_solver.check_batch(psets, flips=0, device="cpu")
    assert port == ref
    verdicts, models = port_solver.feasibility_batch(psets, return_models=True, device="cpu")
    for v, m, code in zip(verdicts, models, port):
        assert v is {port_solver.SAT: True, port_solver.UNSAT: False}.get(code, v)
        if m is not None:
            assert v is True
