"""Batched bit-blasted CNF solver: frontier-wide feasibility on the card (K5).

Replaces ``mythril_tpu/laser/tpu/solver_jax.py``. The host side is the
reference's, copied: a frontier's path conditions are bit-blasted to CNF
(``compile_cnf``, the shared-prefix ``_BlastTrie`` of
``compile_cnf_batch``), padded onto the fixed ``shape_ladder`` buckets
(``_select_bucket``, ``_pack_batch``), warm-started from named-symbol
models (``_warm_plane``) and read back into models (``_extract_model``).

The decider is K5 (``csrc/solve.cu``) with its plain twin
``solve_plain``; ``solve`` launches K5 for CUDA tensors and runs the twin
for CPU tensors. What it computes is the reference's ``_solve_kernel``:

  phase 1 -- three-valued unit propagation to a fixpoint. Each sweep
    reads the previous sweep's values (Jacobi); two clauses forcing
    opposite values in one sweep resolve to the larger (the reference's
    ``.max`` scatter) and the loser conflicts next sweep. A conflict is
    a sound UNSAT, all clauses satisfied a sound SAT. Each instance
    stops at its own fixpoint or conflict, which gives the reference's
    status and, where there is no conflict, its fixpoint bit for bit.
  phase 2 -- under a ``flips`` budget, while UNKNOWN: a status update,
    one unit-force sweep, a decision only when quiescent (the lowest
    unassigned var, input bits first; the warm phase while
    ``steps < flips // 4``, else a random bit) and a restart from the
    phase-1 fixpoint on a conflict. Any all-satisfied assignment is a
    sound SAT witness; UNSAT comes only from phase 1.

The random bit is a 32-bit mix of (seed, instance, step) in both the twin
and the kernel, so K5 equals its twin bit for bit; it differs from jax's
threefry bits, so phase 2 differs from the reference (never its
soundness). The kernel runs one block per instance, its size chosen per
bucket: the clause list is copied once into shared memory (cp.async, then
packed to 16-bit literals) beside the assignment, the phase-1 fixpoint
and the force buffer, and every sweep of both phases is two block
barriers that also reduce its flags. Bound on the H100: the bytes of one
read of the operands plus the writes; the work itself is a chain of
dependent sweeps, so the kernel is latency-bound.
"""

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mythril_tpu_torch import obs
from mythril_tpu_torch.laser.cuda import _build
from mythril_tpu_torch.obs import catalog as _cat
from mythril_tpu_torch.smt import terms
from mythril_tpu_torch.smt.solver import pysat
from mythril_tpu_torch.smt.solver.bitblast import Blaster, BlastError
from mythril_tpu_torch.smt.solver.preprocess import eliminate_theories
from mythril_tpu_torch.smt.terms import Term

log = logging.getLogger(__name__)

SAT = pysat.SAT
UNSAT = pysat.UNSAT
UNKNOWN = pysat.UNKNOWN

# compile-time caps: instances larger than this go to the host CDCL instead.
# Batches are padded to a SMALL FIXED LADDER of (vars, clauses) buckets —
# canonical shapes mean a bounded number of kernel compiles for the process
# lifetime (first XLA compile is tens of seconds; recompiling per frontier
# shape would burn the analysis time budget), while tiny instances stop
# paying full-size kernel work. Tests shrink these knobs.
MAX_VARS = 4096
MAX_CLAUSES = 1 << 14
MAX_BATCH = 64  # larger frontiers are chunked

# the (vars, clauses) pad ladder, as right-shifts of the current caps:
# three diagonal steps (caps/16, caps/4, caps). Derived lazily from
# MAX_VARS/MAX_CLAUSES so test-shrunk caps get a proportionally shrunk
# ladder. The batch axis has its own two-step ladder below.
_LADDER_SHIFTS = (4, 2, 0)
_BATCH_LADDER = (8, MAX_BATCH)


def shape_ladder():
    """Ascending [(pad_vars, pad_clauses)] buckets under the current caps."""
    out = []
    for shift in _LADDER_SHIFTS:
        step = (max(16, MAX_VARS >> shift), max(64, MAX_CLAUSES >> shift))
        if not out or step != out[-1]:
            out.append(step)
    return out


# (I, V, C, flips) shapes this process has dispatched — each is one jit
# specialization of the solve kernel. Bounded by construction:
# |_BATCH_LADDER| x |shape_ladder()| x |distinct flips| (tests assert it).
_compiled_shapes: set = set()

class CapExceeded(Exception):
    """Instance outgrew the device caps during blasting (early abort)."""


class _CappedRecorder:
    """PySat-shaped sink that records CNF instead of solving, aborting as
    soon as the instance exceeds the device size caps."""

    __slots__ = ("nvars", "clauses", "max_vars", "max_clauses")

    def __init__(self, max_vars: int = MAX_VARS, max_clauses: int = MAX_CLAUSES):
        self.nvars = 0
        self.clauses: List[Tuple[int, ...]] = []
        self.max_vars = max_vars
        self.max_clauses = max_clauses

    def new_var(self) -> int:
        self.nvars += 1
        if self.nvars > self.max_vars:
            raise CapExceeded("vars")
        return self.nvars

    def add_clause(self, lits) -> None:
        self.clauses.append(tuple(lits))
        if len(self.clauses) > self.max_clauses:
            raise CapExceeded("clauses")


class CNFInstance:
    """One compiled path condition."""

    __slots__ = ("clause_arr", "nvars", "inputs", "trivial", "var_bits", "bool_vars")

    def __init__(
        self,
        clauses,
        nvars,
        inputs=(),
        trivial: Optional[int] = None,
        var_bits=None,
        bool_vars=None,
    ):
        # pre-packed [n, 3] literal matrix: _pack_batch slice-assigns it
        # instead of looping Python-side per literal on the frontier path
        if isinstance(clauses, np.ndarray):
            arr = clauses
        else:
            arr = np.zeros((len(clauses), 3), dtype=np.int32)
            for ci, cl in enumerate(clauses):
                arr[ci, : len(cl)] = cl
        self.clause_arr = arr
        self.nvars = nvars
        self.inputs = inputs  # SAT vars of the formula's free symbols
        self.trivial = trivial  # SAT/UNSAT decided at compile time, or None
        # (name, size) -> LSB-first bit literals / name -> literal: the
        # bridge between this instance's private var numbering and
        # named-symbol models (warm starts in, witnesses out). CNF var
        # numbers do NOT transfer between instances; models do.
        self.var_bits = var_bits or {}
        self.bool_vars = bool_vars or {}


def compile_cnf(
    assertions: Sequence[Term],
    max_vars: int = MAX_VARS,
    max_clauses: int = MAX_CLAUSES,
) -> Optional[CNFInstance]:
    """Blast one constraint set to a CNF instance; None if it exceeds the
    device caps or contains un-blastable structure."""
    if any(t is terms.FALSE for t in assertions):
        return CNFInstance([], 0, trivial=UNSAT)
    concrete = [t for t in assertions if t is not terms.TRUE]
    if not concrete:
        return CNFInstance([], 0, trivial=SAT)
    rec = _CappedRecorder(max_vars, max_clauses)
    blaster = Blaster(rec)
    try:
        rewritten, _info = eliminate_theories(list(concrete))
        for t in rewritten:
            blaster.assert_formula(t)
    except (CapExceeded, BlastError):
        return None
    inputs = []
    for bits in blaster.var_bits.values():
        inputs.extend(abs(b) for b in bits)
    for lit in blaster.bool_vars.values():
        inputs.append(abs(lit))
    return CNFInstance(
        rec.clauses,
        rec.nvars,
        tuple(inputs),
        var_bits=dict(blaster.var_bits),
        bool_vars=dict(blaster.bool_vars),
    )


def _shrink_dict(d: dict, n: int) -> None:
    # every cache insert during blasting is insert-once (never an
    # overwrite), so the last len(d)-n insertion-ordered keys are exactly
    # the entries added past the savepoint
    while len(d) > n:
        d.popitem()


class _BlastTrie:
    """Shared-prefix incremental blasting for one batch of constraint
    sets.

    Sibling lanes extend their parent's constraint list append-only, so
    a frontier batch re-blasts the same deep prefix once per set —
    measured r6, compile_cnf was ~100% of the device-solve wall time
    (the XLA kernel itself is microseconds). Here the batch is sorted so
    shared prefixes are adjacent, one Blaster/TheoryEliminator pair is
    kept warm, and moving between consecutive sets rolls the state back
    to the common prefix instead of starting over: total gate work is
    the size of the batch's prefix TRIE, not the sum of set sizes.

    Rollback is trail-free: all blaster/eliminator caches are
    insert-once dicts (restored by popping down to the saved length —
    python dicts are insertion-ordered), the clause/side-condition lists
    truncate, and cached word literal-lists are never mutated in place
    so sharing them across savepoints is safe. Asserting a term may
    append Ackermann side conditions mid-stream rather than at the end
    of the set the way eliminate_theories does; the clause set is the
    same, only gate numbering differs (instance numbering is private —
    models travel by symbol name, see CNFInstance.var_bits)."""

    def __init__(self, max_vars: int, max_clauses: int):
        from mythril_tpu_torch.smt.solver.preprocess import TheoryEliminator

        self.rec = _CappedRecorder(max_vars, max_clauses)
        self.blaster = Blaster(self.rec)
        self.elim = TheoryEliminator()
        self._sc_done = 0  # side conditions already asserted

    def savepoint(self):
        b, e = self.blaster, self.elim
        return (
            self.rec.nvars,
            len(self.rec.clauses),
            len(b.gate_cache),
            len(b.word_cache),
            len(b.bool_cache),
            len(b.div_cache),
            len(b.var_bits),
            len(b.bool_vars),
            len(e.memo),
            len(e.sel_vars),
            len(e.app_vars),
            len(e.side_conditions),
            e._fresh,
            self._sc_done,
            {k: len(v) for k, v in e.info.arrays.items()},
            {k: len(v) for k, v in e.info.funcs.items()},
        )

    def rollback(self, sp) -> None:
        b, e = self.blaster, self.elim
        (
            self.rec.nvars,
            n_clauses,
            n_gate,
            n_word,
            n_bool,
            n_div,
            n_vbits,
            n_bvars,
            n_memo,
            n_sel,
            n_app,
            n_sc,
            e._fresh,
            self._sc_done,
            arr_lens,
            fn_lens,
        ) = sp
        del self.rec.clauses[n_clauses:]
        _shrink_dict(b.gate_cache, n_gate)
        _shrink_dict(b.word_cache, n_word)
        _shrink_dict(b.bool_cache, n_bool)
        _shrink_dict(b.div_cache, n_div)
        _shrink_dict(b.var_bits, n_vbits)
        _shrink_dict(b.bool_vars, n_bvars)
        _shrink_dict(e.memo, n_memo)
        _shrink_dict(e.sel_vars, n_sel)
        _shrink_dict(e.app_vars, n_app)
        del e.side_conditions[n_sc:]
        _shrink_dict(e.info.arrays, len(arr_lens))
        for k, n in arr_lens.items():
            del e.info.arrays[k][n:]
        _shrink_dict(e.info.funcs, len(fn_lens))
        for k, n in fn_lens.items():
            del e.info.funcs[k][n:]

    def push(self, t: Term) -> None:
        """Rewrite + assert one more term of the current set, plus any
        Ackermann side conditions its rewrite produced."""
        self.blaster.assert_formula(self.elim.rewrite(t))
        sc = self.elim.side_conditions
        while self._sc_done < len(sc):
            cond = sc[self._sc_done]
            self._sc_done += 1
            self.blaster.assert_formula(cond)

    def snapshot_instance(self) -> CNFInstance:
        b = self.blaster
        clauses = self.rec.clauses
        if clauses:
            arr = np.array(
                [cl + (0,) * (3 - len(cl)) for cl in clauses],
                dtype=np.int32,
            )
        else:
            arr = np.zeros((0, 3), dtype=np.int32)
        inputs = []
        for bits in b.var_bits.values():
            inputs.extend(abs(x) for x in bits)
        for lit in b.bool_vars.values():
            inputs.append(abs(lit))
        return CNFInstance(
            arr,
            self.rec.nvars,
            tuple(inputs),
            var_bits=dict(b.var_bits),
            bool_vars=dict(b.bool_vars),
        )


def compile_cnf_batch(
    constraint_sets: Sequence[Sequence[Term]],
    max_vars: int = MAX_VARS,
    max_clauses: int = MAX_CLAUSES,
) -> List[Optional[CNFInstance]]:
    """Blast a batch of constraint sets with shared-prefix reuse (see
    _BlastTrie). Per-set results match compile_cnf: a CNFInstance
    (possibly trivial), or None past the caps / on un-blastable
    structure."""
    out: List[Optional[CNFInstance]] = [None] * len(constraint_sets)
    keyed = []
    for i, cs in enumerate(constraint_sets):
        if any(t is terms.FALSE for t in cs):
            out[i] = CNFInstance([], 0, trivial=UNSAT)
            continue
        concrete = [t for t in cs if t is not terms.TRUE]
        if not concrete:
            out[i] = CNFInstance([], 0, trivial=SAT)
            continue
        keyed.append((tuple(t.uid for t in concrete), i, concrete))
    if not keyed:
        return out
    keyed.sort(key=lambda kic: kic[0])
    trie = _BlastTrie(max_vars, max_clauses)
    saves = [trie.savepoint()]  # saves[d] = state with d terms asserted
    path: Tuple[int, ...] = ()
    failed: Optional[Tuple[int, ...]] = None
    for key, i, concrete in keyed:
        # a prefix that blew the caps (or hit un-blastable structure)
        # fails identically for every extension — sorted order puts them
        # right here, so skip without re-blasting
        if failed is not None and key[: len(failed)] == failed:
            continue
        k = 0
        m = min(len(path), len(key))
        while k < m and path[k] == key[k]:
            k += 1
        trie.rollback(saves[k])
        del saves[k + 1 :]
        path = key[:k]
        ok = True
        for t in concrete[k:]:
            try:
                trie.push(t)
            except (CapExceeded, BlastError):
                # partial writes past the last savepoint: discard them
                trie.rollback(saves[-1])
                failed = key[: len(saves)]
                path = key[: len(saves) - 1]
                ok = False
                break
            saves.append(trie.savepoint())
        if ok:
            path = key
            out[i] = trie.snapshot_instance()
    return out


def _pow2(n: int, lo: int = 16, ladder=None) -> int:
    """Next padded size. With a ``ladder`` the growth is CLAMPED to the
    fixed bucket steps (bounded jit specializations) instead of free
    power-of-two growth; values beyond the last step return it."""
    if ladder is not None:
        for step in ladder:
            if n <= step:
                return step
        return ladder[-1]
    v = lo
    while v < n:
        v <<= 1
    return v


def _select_bucket(need_vars: int, need_clauses: int):
    """Smallest ladder bucket fitting the instance — promoted to an
    ALREADY-COMPILED larger bucket when one exists (padding waste is
    microseconds; an extra XLA compile is tens of seconds)."""
    ladder = shape_ladder()
    fit = None
    for step in ladder:
        if need_vars <= step[0] and need_clauses <= step[1]:
            fit = step
            break
    if fit is None:
        fit = (max(ladder[-1][0], need_vars), max(ladder[-1][1], need_clauses))
    compiled = {(v, c) for (_i, v, c, _f) in _compiled_shapes}
    if fit not in compiled:
        for step in ladder:
            if step in compiled and step[0] >= fit[0] and step[1] >= fit[1]:
                return step
    return fit


def _pack_batch(instances: List[CNFInstance], pad_vars: int, pad_clauses: int):
    """Pad live instances into canonical [I, C, 3] clause tensors, the
    batch axis to the next step of the batch ladder (K5 takes every
    shape as a launch argument, so no step costs a compile)."""
    C = pad_clauses
    V = pad_vars
    I = _pow2(len(instances), ladder=_BATCH_LADDER)
    lits = np.zeros((I, C, 3), dtype=np.int32)
    nvars = np.zeros((I,), dtype=np.int32)
    is_input = np.zeros((I, V), dtype=bool)
    for k, inst in enumerate(instances):
        nvars[k] = inst.nvars
        if inst.inputs:
            is_input[k, np.asarray(inst.inputs, dtype=np.int64) - 1] = True
        lits[k, : inst.clause_arr.shape[0]] = inst.clause_arr
    return lits, nvars, is_input, V


launches = 0  # K5 launches (CUDA path only)
SOLVE_MAX_VARS = 32767  # K5's literals are int16 in shared memory (csrc/solve.cuh)

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def phase_bits(seed: int, inst: torch.Tensor, step: int) -> torch.Tensor:
    """Bit 0 of the 32-bit mix of (seed, instance, step): the decision
    phase's random bit (csrc/solve.cuh solve_mix32), bool per instance."""
    h = (_mul32(torch.full_like(inst, seed & _M32), 0x9E3779B1)
         + _mul32(inst & _M32, 0x85EBCA77)
         + _mul32(torch.full_like(inst, step & _M32), 0xC2B2AE3D)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h & 1) == 1


def solve_plain(lits, nvars, is_input, warm, flips: int, seed: int):
    """The twin of K5 (any device). lits: [I, C, 3] int32 (0-padded);
    nvars: [I] int32 real var counts; is_input: [I, V] bool, the formula's
    free-symbol bits (decided first); warm: [I, V] int8 preferred phases
    (0 = none). Returns (status int32[I], assign bool[I, V], sweeps
    int32[I]: phase-1 sweeps plus phase-2 steps per instance)."""
    I, C, _ = lits.shape
    V = is_input.shape[1]
    dev = lits.device
    lits = lits.to(torch.int64)
    var = lits.abs() - 1
    vidx = var.clamp(0, V - 1).reshape(I, C * 3)
    sign = lits > 0
    real = lits != 0
    real_clause = real.any(-1)

    def sweep(val):
        v = torch.gather(val, 1, vidx).reshape(I, C, 3)
        lit_val = torch.where(real, torch.where(sign, v, -v), torch.zeros_like(v))
        c_sat = (lit_val == 1).any(-1)
        unk = (lit_val == 0) & real
        n_unknown = unk.sum(-1)
        dead = real_clause & ~c_sat & (n_unknown == 0)
        unit = real_clause & ~c_sat & (n_unknown == 1)
        unk_pos = torch.argmax(unk.to(torch.int8), dim=-1)  # first unknown literal
        u_lit = torch.gather(lits, 2, unk_pos[..., None])[..., 0]
        u_var = (u_lit.abs() - 1).clamp(0, V - 1)
        u_val = torch.where(u_lit > 0, 1, -1)
        upd = torch.full((I, V), -2, dtype=torch.int64, device=dev)
        upd.scatter_reduce_(1, u_var, torch.where(unit, u_val, -2), reduce="amax")
        new_val = torch.where((val == 0) & (upd > -2), upd, val)
        allsat = (c_sat | ~real_clause).all(-1)
        return new_val, dead.any(-1), allsat

    # ---- phase 1: each instance to its own fixpoint or conflict
    val = torch.zeros((I, V), dtype=torch.int64, device=dev)
    conflict = torch.zeros(I, dtype=torch.bool, device=dev)
    allsat = torch.zeros(I, dtype=torch.bool, device=dev)
    active = torch.ones(I, dtype=torch.bool, device=dev)
    sweeps = torch.zeros(I, dtype=torch.int32, device=dev)
    while bool(active.any()):
        new_val, dead, sat = sweep(val)
        changed = (new_val != val).any(-1)
        val = torch.where(active[:, None], new_val, val)
        allsat = torch.where(active, sat, allsat)
        conflict = conflict | (active & dead)
        sweeps += active.to(torch.int32)
        active = active & changed & ~conflict
    status = torch.where(
        conflict, UNSAT, torch.where(allsat, SAT, UNKNOWN)
    ).to(torch.int32)

    # ---- the restart point, then the warm seed (every instance)
    fixed = val
    warm = warm.to(torch.int64)
    varmask = torch.arange(V, device=dev)[None, :] < nvars.to(torch.int64)[:, None]
    val = torch.where((val == 0) & varmask & (warm != 0), warm, val)

    # ---- phase 2
    inst = torch.arange(I, device=dev, dtype=torch.int64)
    rows = torch.arange(I, device=dev)
    prio = torch.arange(V, 0, -1, device=dev, dtype=torch.int64)  # lowest index wins
    active = status == UNKNOWN
    step = 0
    while step < flips and bool(active.any()):
        new_val, dead, sat = sweep(val)
        status = torch.where(active & sat & ~dead, SAT, status).to(torch.int32)
        changed = (new_val != val).any(-1)
        cand = (new_val == 0) & varmask
        cand_in = cand & is_input
        pool = torch.where(cand_in.any(-1, keepdim=True), cand_in, cand)
        dvar = torch.argmax(torch.where(pool, prio, 0), dim=-1)
        need = active & (status == UNKNOWN) & ~dead & ~changed & cand.any(-1)
        dphase = torch.where(phase_bits(seed, inst, step), 1, -1)
        wcol = warm[rows, dvar]
        if step < flips // 4:
            dphase = torch.where(wcol != 0, wcol, dphase)
        decided = new_val.clone()
        decided[rows, dvar] = torch.where(need, dphase, new_val[rows, dvar])
        restart = active & dead & (status == UNKNOWN)
        decided = torch.where(restart[:, None], fixed, decided)
        val = torch.where(active[:, None], decided, val)
        sweeps += active.to(torch.int32)
        active = active & (status == UNKNOWN)
        step += 1
    return status, val > 0, sweeps


def solve(lits, nvars, is_input, warm, flips: int, seed: int, device="cuda"):
    """K5 on CUDA operands, the twin on CPU operands; same contract as
    ``solve_plain``."""
    dev = _build.check_on(device, lits, nvars, is_input, warm)
    if dev.type == "cpu":
        return solve_plain(lits, nvars, is_input, warm, flips, seed)
    I, C, _ = lits.shape
    V = is_input.shape[1]
    for t, name, dt, shape in (
        (lits, "lits", torch.int32, (I, C, 3)),
        (nvars, "nvars", torch.int32, (I,)),
        (is_input, "is_input", torch.bool, (I, V)),
        (warm, "warm", torch.int8, (I, V)),
    ):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise _build.KernelError(f"solve: {name} must be a contiguous {dt} tensor of shape {shape}")
    if V > SOLVE_MAX_VARS:
        raise _build.KernelError(f"solve: K5 packs literals in 16 bits, so at most {SOLVE_MAX_VARS} vars, not {V}")
    status = torch.empty(I, dtype=torch.int32, device=dev)
    assign = torch.empty((I, V), dtype=torch.bool, device=dev)
    sweeps = torch.empty(I, dtype=torch.int32, device=dev)
    from mythril_tpu_torch.laser.cuda import kernels

    global launches
    launches += 1
    kernels.launch_solve(lits, nvars, is_input, warm, status, assign, sweeps, flips, seed)
    return status, assign, sweeps


_seed_counter = [0]



def _warm_plane(chunk, models, I: int, V: int):
    """[I, V] int8 decision-phase hints from named-symbol models (0 =
    no hint). Model keys are ("bv", name, size) -> int and
    ("bool", name) -> bool; each instance re-projects them onto its own
    private CNF var numbering via the retained blaster maps."""
    warm = np.zeros((I, V), dtype=np.int8)
    for k, (inst, model) in enumerate(zip(chunk, models)):
        if not model:
            continue
        for (name, size), bits in inst.var_bits.items():
            val = model.get(("bv", name, size))
            if val is None:
                continue
            for bi, lit in enumerate(bits):
                v = abs(lit) - 1
                if 0 <= v < V:
                    bit_set = ((val >> bi) & 1) == 1
                    warm[k, v] = 1 if bit_set == (lit > 0) else -1
        for name, lit in inst.bool_vars.items():
            bval = model.get(("bool", name))
            v = abs(lit) - 1
            if bval is not None and 0 <= v < V:
                warm[k, v] = 1 if bool(bval) == (lit > 0) else -1
    return warm


def _extract_model(inst: CNFInstance, assign_row) -> dict:
    """Named-symbol model from a verified SAT assignment row."""
    model: dict = {}
    for (name, size), bits in inst.var_bits.items():
        val = 0
        for bi, lit in enumerate(bits):
            v = abs(lit) - 1
            if 0 <= v < len(assign_row) and bool(assign_row[v]) == (lit > 0):
                val |= 1 << bi
        model[("bv", name, size)] = val
    for name, lit in inst.bool_vars.items():
        v = abs(lit) - 1
        if 0 <= v < len(assign_row):
            model[("bool", name)] = bool(assign_row[v]) == (lit > 0)
    return model


def check_batch(
    constraint_sets: Sequence[Sequence[Term]],
    flips: Optional[int] = None,
    max_vars: int = MAX_VARS,
    max_clauses: int = MAX_CLAUSES,
    models: Optional[Sequence[Optional[dict]]] = None,
    return_models: bool = False,
    device="cuda",
):
    """Decide a batch of path conditions on ``device``.

    Returns one of pysat.SAT / pysat.UNSAT / pysat.UNKNOWN per input set.
    SAT and UNSAT results are sound (see module docstring); UNKNOWN means
    the caller should fall back to the host CDCL core.

    ``models`` optionally supplies per-set named-symbol warm-start hints
    (see _warm_plane); ``return_models=True`` additionally returns the
    named-symbol witness for each SAT verdict:
    ``(codes, [model-or-None])``. Instances are grouped onto the fixed
    (vars, clauses) pad ladder so jit specializations stay bounded.
    """
    from mythril_tpu_torch.robustness import faults

    faults.fire(faults.SOLVER_BATCH, context="check_batch")
    n = len(constraint_sets)
    results = [UNKNOWN] * n
    models_out: List[Optional[dict]] = [None] * n
    max_vars = min(max_vars, MAX_VARS)
    max_clauses = min(max_clauses, MAX_CLAUSES)
    live_idx = []
    live_instances = []
    # bitblast/CNF compile cost attributed separately from the kernel
    # dispatch (obs: the two dominate different workloads)
    with obs.TRACER.span("cnf_compile", tid="solve", n=n):
        compiled = list(
            compile_cnf_batch(constraint_sets, max_vars, max_clauses)
        )
    cnf_vars = 0
    cnf_clauses = 0
    for i, inst in enumerate(compiled):
        if inst is None:
            continue
        if inst.trivial is not None:
            results[i] = inst.trivial
            continue
        cnf_vars += int(inst.nvars)
        cnf_clauses += int(inst.clause_arr.shape[0])
        live_idx.append(i)
        live_instances.append(inst)
    # real blast volume: what the rewrite pass is measured against
    # (MYTHRIL_TPU_REWRITE=0 control; docs/REWRITE_PASS.md)
    if cnf_vars:
        _cat.CNF_VARS_TOTAL.inc(cnf_vars)
        _cat.CNF_CLAUSES_TOTAL.inc(cnf_clauses)
    if not live_instances:
        return (results, models_out) if return_models else results

    if flips is None:
        flips = min(2 * MAX_VARS + 512, 4096)

    # group by pad bucket (homogeneous chunks), then chunk by MAX_BATCH
    groups: dict = {}
    for j, inst in enumerate(live_instances):
        bucket = _select_bucket(inst.nvars, inst.clause_arr.shape[0])
        groups.setdefault(bucket, []).append(j)
    for (V_b, C_b), members in sorted(groups.items()):
        for lo in range(0, len(members), MAX_BATCH):
            chunk_js = members[lo : lo + MAX_BATCH]
            chunk = [live_instances[j] for j in chunk_js]
            lits, nvars, is_input, V = _pack_batch(chunk, V_b, C_b)
            I = lits.shape[0]
            chunk_models = [
                models[live_idx[j]] if models is not None else None
                for j in chunk_js
            ]
            warm = _warm_plane(chunk, chunk_models, I, V)
            _seed_counter[0] += 1
            # one upload: the operand arrays ride a single buffer
            from mythril_tpu_torch.laser.cuda import transfer

            d_lits, d_nvars, d_input, d_warm = transfer.upload_segments(
                [lits, nvars, is_input, warm], device=device
            )
            _compiled_shapes.add((I, V, C_b, flips))
            status, assign, _sweeps = solve(
                d_lits, d_nvars, d_input, d_warm, flips, _seed_counter[0], device=device
            )
            with _build.sync_point():
                status = status.cpu().numpy()
                assign_np = assign.cpu().numpy() if return_models else None
            for k, j in enumerate(chunk_js):
                code = int(status[k])
                results[live_idx[j]] = code
                if return_models and code == SAT:
                    models_out[live_idx[j]] = _extract_model(
                        live_instances[j], assign_np[k]
                    )
    return (results, models_out) if return_models else results


def feasibility_batch(
    constraint_sets,
    models: Optional[Sequence[Optional[dict]]] = None,
    return_models: bool = False,
    **kw,
) -> List[Optional[bool]]:
    """Frontier filtering helper: True (feasible) / False (infeasible) /
    None (undecided on device; check on host). With
    ``return_models=True`` returns ``(verdicts, witness models)``."""
    res = check_batch(
        constraint_sets, models=models, return_models=return_models, **kw
    )
    codes, witness = res if return_models else (res, None)
    out = []
    for code in codes:
        if code == SAT:
            out.append(True)
        elif code == UNSAT:
            out.append(False)
        else:
            out.append(None)
    return (out, witness) if return_models else out
