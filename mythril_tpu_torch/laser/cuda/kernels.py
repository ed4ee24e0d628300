"""ctypes plumbing shared by the kernel wrappers (K1, K3-K12).

The C side (``csrc/common.cuh``) takes the StateBatch as one ``Planes``
struct: a pointer and a row size in bytes per plane, in
``StateBatch._fields`` order, plus the batch's dimensions. The wrappers
in engine.py, inloop_solve.py and megakernel.py check devices, dtypes and
contiguity here before any pointer reaches a kernel.
"""

import ctypes
import threading

import numpy as np
import torch

from mythril_tpu_torch.laser.cuda import _build, symtape
from mythril_tpu_torch.laser.cuda.batch import JD_RING, StateBatch, batch_shapes, BatchConfig

NFIELDS = len(StateBatch._fields)
_DTYPES = {k: dt for k, (_s, dt) in batch_shapes(BatchConfig()).items()}


class Planes(ctypes.Structure):
    _fields_ = [
        ("p", ctypes.c_void_p * NFIELDS),
        ("row_bytes", ctypes.c_int64 * NFIELDS),
    ] + [(n, ctypes.c_int) for n in ("L", "S", "M", "C", "K", "CL", "T", "P", "MS", "SSR", "JD", "n_codes")]


class Bank(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "code", "code_len", "jumpdest", "push_imm", "host_ops", "freeze_errors",
        "record_storage_events", "must_revert", "prune_revert", "jumpi_verdict",
    )]


class Pool(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("var_h1", "var_h2", "lit_var", "lit_neg", "lit_used")] + [
        (n, ctypes.c_int) for n in ("V", "C", "W")
    ]


def _checked(t: torch.Tensor, name: str, dtype: torch.dtype, dev) -> torch.Tensor:
    if t.device != dev:
        raise _build.KernelError(f"{name} on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise _build.KernelError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise _build.KernelError(f"{name} is not contiguous")
    return t


_PLANE_DTYPES = []  # torch dtype per StateBatch field, filled at first use


def planes(st: StateBatch, n_codes: int, code_len: int) -> Planes:
    from mythril_tpu_torch.laser.cuda import convert

    if not _PLANE_DTYPES:
        _PLANE_DTYPES.extend(convert.torch_dtype(_DTYPES[name]) for name in StateBatch._fields)
    dev = st.pc.device
    L = st.pc.shape[0]
    D = 16
    pl = Planes()
    p, rb = pl.p, pl.row_bytes
    for i, t in enumerate(st):
        if t.dtype != _PLANE_DTYPES[i] or t.device != dev or not t.is_contiguous():
            _checked(t, StateBatch._fields[i], _PLANE_DTYPES[i], dev)  # raises, naming the plane
        if t.shape[0] != L:
            raise _build.KernelError(f"{StateBatch._fields[i]} is not lane-major")
        p[i] = t.data_ptr()
        rb[i] = t.stride(0) * t.element_size() if t.dim() > 1 else t.element_size()
    if st.visited.shape[1] != code_len:
        raise _build.KernelError("visited width differs from the code bank's code_len")
    pl.L, pl.S, pl.M, pl.C = L, st.stack.shape[1] // D, st.memory.shape[1], st.calldata.shape[1]
    pl.K, pl.CL, pl.T, pl.P = st.storage_key.shape[1] // D, code_len, st.tape_op.shape[1], st.path_id.shape[1]
    pl.MS, pl.SSR, pl.JD, pl.n_codes = st.msym_off.shape[1], st.ss_pc.shape[1], JD_RING, n_codes
    return pl


def bank(cb) -> Bank:
    from mythril_tpu_torch.laser.cuda import convert

    dev = cb.code.device
    bk = Bank()
    for name in Bank._fields_:
        name = name[0]
        t = _checked(getattr(cb, name), name, convert.torch_dtype(convert.CODE_BANK_DTYPES[name]), dev)
        setattr(bk, name, t.data_ptr())
    return bk


def pool_struct(pool) -> Pool:
    from mythril_tpu_torch.laser.cuda import convert

    dev = pool.var_h1.device
    ps = Pool()
    for name, _ in Pool._fields_[:5]:
        t = _checked(getattr(pool, name), name, convert.torch_dtype(convert.POOL_DTYPES[name]), dev)
        setattr(ps, name, t.data_ptr())
    ps.V = pool.var_h1.shape[0]
    ps.C, ps.W = pool.lit_var.shape
    return ps


def op_tables(dev) -> torch.Tensor:
    """int32[9*256] opcode tables in csrc/common.cuh Table order."""
    from mythril_tpu_torch.laser.cuda import engine

    rows = [
        engine._POPS, engine._PUSHES, engine._GAS, engine._GAS_MAX, engine._INVALID,
        engine._TRAP_TABLE, symtape.SYM_OP, symtape.SYM_ARITY, symtape.ENV_LEAF_OP,
    ]
    return torch.as_tensor(np.concatenate([np.asarray(r, np.int64) for r in rows]).astype(np.int32), device=dev)


class Scratch:
    """Per-(device, stream, L) scratch buffers for the step and the
    epilogue: K1's per-step lane flags and, with stats, each lane's
    pre-step opcode and steps (``hrec``, int32[2L]); K4's plan flags,
    order and dying mask. Shared by the loops on one stream, whose
    launches run in order; each launch writes these before it reads them,
    so loops of two threads may interleave their launches there. A loop
    on another stream gets its own."""

    _cache = {}
    _lock = threading.Lock()

    def __init__(self, dev, L):
        self.tab = op_tables(dev)
        self.flags = torch.zeros(L, dtype=torch.uint8, device=dev)
        self.hrec = torch.zeros(2 * L, dtype=torch.int32, device=dev)
        self.eflags = torch.zeros(L, dtype=torch.uint8, device=dev)
        self.order = torch.empty(L, dtype=torch.int32, device=dev)
        self.dying = torch.empty(L, dtype=torch.uint8, device=dev)

    @classmethod
    def get(cls, dev, L):
        key = (str(dev), _build.stream_key(dev), L)
        with cls._lock:
            if key not in cls._cache:
                cls._cache[key] = cls(dev, L)
            return cls._cache[key]


_FNS = {}
_P = ctypes.POINTER
_V = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    ("step", "mt_step_run"): [_P(Planes), _P(Bank)] + [_V] * 5 + [_I] * 4 + [_V],
    ("step", "mt_step_run_info"): [_V, _I],
    ("inloop", "mt_unsat_mask"): [_P(Planes), _P(Pool), _V, _V, _I, _V],
    ("inloop", "mt_unsat_mask_info"): [_V],
    ("megakernel", "mt_round_epilogue"): [_P(Planes), _P(Planes)] + [_V] * 8 + [_I, _I, _I, _V, _I, _V],
    ("megakernel", "mt_round_epilogue_info"): [_V],
    ("solve", "mt_solve"): [_V] * 7 + [_I] * 5 + [ctypes.c_uint32, _V],
    ("solve", "mt_solve_info"): [_V, _I, _I, _I],
    ("transfer", "mt_xfer"): [_V, _I, ctypes.c_uint32, _V],
    ("hist", "mt_op_hist"): [_V, _I, _I] + [_V] * 4 + [_I, _V, _V],
    ("slice", "mt_slice_ctl"): [_V, _V, _I, _V, _I, _V],
    ("mesh", "mt_mesh_steal"): [_P(Planes), _I, _I] + [_V] * 5 + [_I, _V],
    ("mesh", "mt_mesh_info"): [_V, _I],
    ("mesh", "mt_mesh_deal"): [_P(Planes), _P(Planes), _I, _V, _I, _V],
    ("mesh", "mt_mesh_launches"): [_V],
    ("mesh", "mt_mesh_cards"): [_P(Planes), _P(Planes), _V] + [_I] * 4 + [_V] * 3 + [_I, _I, _V],
    ("mesh", "mt_mesh_enable_peers"): [_V, _I],
}

# K4 flags (csrc/megakernel.cuh) and the steal kernel's (csrc/mesh.cuh)
EPI_COMMIT = 1
EPI_COMPACT_ONLY = 2
MESH_PLAN = 1
MESH_GATE_SPREAD = 2
MESH_ACCUM = 4
MESH_MOVE = 8
MESH_STEAL_ROUND = MESH_PLAN | MESH_GATE_SPREAD | MESH_ACCUM | MESH_MOVE
MESH_MAX_SHARDS = 64
MESH_MAX_LANES = 1024
MESH_MAX_CARDS = 8
# the cross-card exchange's modes (csrc/mesh.cuh)
XC_COUNT = 0
XC_PLAN = 1
XC_PULL = 2


def _fn(lib: str, name: str):
    fn = _FNS.get((lib, name))
    if fn is None:
        fn = getattr(_build.library(lib), name)
        fn.argtypes = _SIGS[(lib, name)]
        fn.restype = ctypes.c_int
        _FNS[(lib, name)] = fn
    return fn


def _vp(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


class StepArgs:
    """The structs a K1 launch needs, built once per batch: the fused
    loop steps one batch in place, so its pointers never change.
    ``n_shards`` > 1 ranks forks inside each contiguous lane block (the
    fused mesh tier)."""

    def __init__(self, cb, st: StateBatch, n_shards: int = 1):
        dev = st.pc.device
        if n_shards < 1 or st.pc.shape[0] % n_shards:
            raise _build.KernelError(f"{st.pc.shape[0]} lanes do not split into {n_shards} shards")
        self.sc = Scratch.get(dev, st.pc.shape[0])
        self.pl = planes(st, cb.code.shape[0], cb.code.shape[1])
        self.bk = bank(cb)
        self.stream = _build.stream(dev)
        self.n_shards = int(n_shards)


def launch_step_run(a: StepArgs, n_steps: int, ctl=None, blocks: int = 0, hist=None) -> None:
    """K1: ``n_steps`` steps of every lane in one cooperative launch, of
    as many blocks as the lanes need and the card holds at once
    (``blocks`` > 0: exactly that many). With ``hist`` (int32[256]
    holding u32 bits) the launch also adds every step's retired opcodes
    into it (K1's stats instance). A launch the card refuses (too large
    to be resident) raises."""
    sc = a.sc
    if hist is not None:
        _checked(hist, "hist", torch.int32, sc.hrec.device)
        if hist.shape != (256,):
            raise _build.KernelError("the histogram must be int32[256]")
    rc = _fn("step", "mt_step_run")(
        ctypes.byref(a.pl), ctypes.byref(a.bk), _vp(sc.tab), _vp(sc.flags), _vp(ctl), _vp(hist),
        _vp(sc.hrec if hist is not None else None), a.n_shards, int(n_steps), int(blocks), NFIELDS, a.stream)
    _build.check(rc, "step run", "step")


def _kernel_info(lib: str, name: str, dev, n: int, *extra) -> list:
    out = (ctypes.c_int * n)()
    with torch.cuda.device(dev):
        _build.check(_fn(lib, name)(ctypes.cast(out, ctypes.c_void_p), *extra), name, lib)
    return list(out)


_INFO_KEYS = ("registers", "local_bytes", "shared_bytes", "threads_per_block", "blocks_per_sm", "sms")


def step_run_info(dev, stats: bool = False) -> dict:
    """K1's compiled resources on ``dev`` (its stats instance with
    ``stats``): registers and local (spill and stack) bytes per thread,
    static shared bytes and threads per block, blocks resident per SM,
    SMs."""
    return dict(zip(_INFO_KEYS, _kernel_info("step", "mt_step_run_info", dev, 6, int(bool(stats)))))


def unsat_info(dev) -> dict:
    """K3's compiled resources: registers and local bytes per thread,
    static shared bytes and threads per block."""
    return dict(zip(_INFO_KEYS, _kernel_info("inloop", "mt_unsat_mask_info", dev, 4)))


def epilogue_info(dev) -> dict:
    """K4's compiled resources, as ``step_run_info``."""
    return dict(zip(_INFO_KEYS, _kernel_info("megakernel", "mt_round_epilogue_info", dev, 6)))


def mesh_steal_info(dev) -> dict:
    """The steal kernel's (K10/K11) compiled resources, as ``step_run_info``."""
    return dict(zip(_INFO_KEYS, _kernel_info("mesh", "mt_mesh_info", dev, 6, 0)))


def mesh_deal_info(dev) -> dict:
    """K12's compiled resources, as ``step_run_info``."""
    return dict(zip(_INFO_KEYS, _kernel_info("mesh", "mt_mesh_info", dev, 6, 1)))


def mesh_cards_info(dev) -> dict:
    """The cross-card exchange's compiled resources, as ``step_run_info``."""
    return dict(zip(_INFO_KEYS, _kernel_info("mesh", "mt_mesh_info", dev, 6, 2)))


def solve_info(dev, C: int, V: int, threads: int = 0) -> dict:
    """K5's compiled resources and its launch for C clauses over V vars
    (``threads`` 0: the bucket's own block size): registers and local
    bytes per thread, static and dynamic shared bytes and threads per
    block, blocks resident per SM."""
    keys = ("registers", "local_bytes", "shared_bytes", "threads_per_block", "dynamic_shared_bytes",
            "blocks_per_sm")
    return dict(zip(keys, _kernel_info("solve", "mt_solve_info", dev, 6, int(C), int(V), int(threads))))


def launch_solve(lits, nvars, is_input, warm, status, assign, sweeps, flips: int, seed: int,
                 threads: int = 0) -> None:
    """K5 on checked CUDA operands (solver.solve's contract), one block of
    ``threads`` threads an instance (0: the bucket's own block size)."""
    I, C, _ = lits.shape
    V = is_input.shape[1]
    rc = _fn("solve", "mt_solve")(
        *(_vp(t) for t in (lits, nvars, is_input, warm, status, assign, sweeps)),
        I, C, V, int(flips), int(threads), seed & 0xFFFFFFFF, _build.stream(lits.device))
    _build.check(rc, "solve", "solve")


def _same(built, given) -> bool:
    return all(a is b for a, b in zip(built, given))


class UnsatArgs:
    """The arguments of a K3 launch, checked and built once: the fused
    loops screen the same batch into the same mask every round, with a
    pool fixed for the super-round."""

    def __init__(self, pool, st: StateBatch, ctl=None, out=None):
        dev = st.pc.device
        L = st.pc.shape[0]
        if out is None:
            out = torch.zeros(L, dtype=torch.bool, device=dev)
        _checked(out, "out", torch.bool, dev)
        if out.shape != (L,):
            raise _build.KernelError(f"the unsat mask must be bool[{L}]")
        if ctl is not None:
            _checked(ctl, "ctl", torch.int32, dev)
        self.pl = planes(st, 1, st.visited.shape[1])
        self.ps = pool_struct(pool)
        if self.ps.V > 256:
            raise _build.KernelError("unsat_mask kernel takes at most 256 pool variables")
        self.out = out
        self.keep = (pool, st, ctl)  # the tensors behind the pointers
        self.argv = (ctypes.byref(self.pl), ctypes.byref(self.ps), _vp(out), _vp(ctl), NFIELDS, _build.stream(dev))

    def check(self, pool, st, ctl, out) -> None:
        """Raise unless the launch's own arguments are those these were
        built for (``out`` None: any)."""
        if not _same(self.keep, (pool, st, ctl)) or (out is not None and out is not self.out):
            raise _build.KernelError("unsat_mask: the prebuilt arguments are for other tensors")


def launch_unsat(pool, st: StateBatch, ctl=None, out=None, args: UnsatArgs = None) -> torch.Tensor:
    """K3 on a CUDA batch; returns bool[L] (``out`` if given). ``args``,
    built once by a loop, stands for ``pool``, ``st``, ``ctl`` and ``out``."""
    a = args if args is not None else UnsatArgs(pool, st, ctl, out)
    if args is not None:
        a.check(pool, st, ctl, out)
    _build.check(_fn("inloop", "mt_unsat_mask")(*a.argv), "unsat_mask", "inloop")
    return a.out


class EpilogueArgs:
    """The arguments of a K4 launch, checked and built once: the fused
    loops run the epilogue every round on the same batch, scratch batch,
    mask, accumulators and control word, updated in place. ``flags`` and
    ``gate`` are given per launch (the fused mesh loop runs two kinds)."""

    def __init__(self, cb, st, unsat, acc, pv, ctl, max_rounds, scratch, n_shards=1):
        dev = st.pc.device
        L = st.pc.shape[0]
        sc = Scratch.get(dev, L)
        n_codes, CL = cb.code.shape
        self.pl = planes(st, n_codes, CL)
        self.ps = planes(scratch, n_codes, CL)
        _checked(unsat, "unsat", torch.bool, dev)
        _checked(acc, "acc", torch.int32, dev)
        _checked(pv, "pruned_visited", torch.bool, dev)
        _checked(ctl, "ctl", torch.int32, dev)
        _checked(cb.prune_revert, "prune_revert", torch.bool, dev)
        if pv.shape != (n_codes, CL) or ctl.numel() != 4 or acc.numel() != 4 or unsat.shape != (L,):
            raise _build.KernelError("bad pruned_visited / ctl / acc / unsat shape")
        if n_shards < 1 or L % n_shards:
            raise _build.KernelError(f"{L} lanes do not split into {n_shards} shards")
        self.argv = (
            ctypes.byref(self.pl), ctypes.byref(self.ps), _vp(cb.prune_revert), _vp(unsat), _vp(acc),
            _vp(sc.order), _vp(sc.dying), _vp(sc.eflags), _vp(pv), _vp(ctl), int(max_rounds), int(n_shards))
        self.keep = (cb, st, unsat, acc, pv, ctl, scratch)  # the tensors behind the pointers
        self.sc = sc
        self.shape = (int(max_rounds), int(n_shards))
        self.stream = _build.stream(dev)
        self.dev = dev

    def check(self, cb, st, unsat, acc, pv, ctl, max_rounds, scratch, n_shards) -> None:
        """Raise unless the launch's own arguments are those these were
        built for."""
        if not _same(self.keep, (cb, st, unsat, acc, pv, ctl, scratch)) or \
                self.shape != (int(max_rounds), int(n_shards)):
            raise _build.KernelError("round_epilogue: the prebuilt arguments are for other tensors or shards")


def launch_epilogue(cb, st, unsat, acc, pv, ctl, max_rounds, scratch, n_shards=1, flags=EPI_COMMIT,
                    gate=None, args: EpilogueArgs = None) -> None:
    """K4 on a CUDA batch, one cooperative launch: prune/kill/fold/compact
    in place, the compaction stable inside each of ``n_shards`` lane
    blocks. ``flags`` (EPI_COMMIT, EPI_COMPACT_ONLY) and ``gate`` (an
    int32 word; the launch does nothing while it is 0 but commit) serve
    the fused mesh loop. ``args``, built once by a loop, stands for the
    other arguments. The grid is as many blocks as the lanes need and the
    card holds at once."""
    a = args if args is not None else EpilogueArgs(cb, st, unsat, acc, pv, ctl, max_rounds, scratch, n_shards)
    if args is not None:
        a.check(cb, st, unsat, acc, pv, ctl, max_rounds, scratch, n_shards)
    if gate is not None:
        _checked(gate, "gate", torch.int32, a.dev)
    rc = _fn("megakernel", "mt_round_epilogue")(*a.argv, int(flags), _vp(gate), NFIELDS, a.stream)
    _build.check(rc, "round_epilogue", "megakernel")


class HistArgs:
    """The arguments of a K8 launch, checked and built once: ``before``
    needs ``code_id``, ``pc`` and ``steps``, ``after`` its ``steps``."""

    def __init__(self, cb, before, after, hist):
        dev = after.steps.device
        L = after.steps.shape[0]
        for name, t in (("b_code_id", before.code_id), ("b_pc", before.pc), ("b_steps", before.steps),
                        ("a_steps", after.steps)):
            _checked(t, name, torch.int32, dev)
            if t.shape != (L,):
                raise _build.KernelError(f"{name} has shape {tuple(t.shape)}, expected ({L},)")
        _checked(cb.code, "code", torch.uint8, dev)
        _checked(hist, "hist", torch.int32, dev)
        if hist.shape != (256,):
            raise _build.KernelError("the histogram must be int32[256]")
        n_codes, CL = cb.code.shape
        self.argv = (_vp(cb.code), n_codes, CL, _vp(before.code_id), _vp(before.pc), _vp(before.steps),
                     _vp(after.steps), L, _vp(hist), _build.stream(dev))


def launch_op_hist(a: HistArgs) -> None:
    """K8: add one step's retired opcodes into the histogram (int32[256]
    holding u32 bits)."""
    _build.check(_fn("hist", "mt_op_hist")(*a.argv), "op_hist", "hist")


class SliceArgs:
    """The arguments of a K9 launch, checked and built once."""

    def __init__(self, st: StateBatch, ctl, max_steps: int):
        dev = st.alive.device
        _checked(st.alive, "alive", torch.bool, dev)
        _checked(st.status, "status", torch.int32, dev)
        _checked(ctl, "ctl", torch.int32, dev)
        if ctl.numel() != 4:
            raise _build.KernelError("the slice control word must be int32[4]")
        self.argv = (_vp(st.alive), _vp(st.status), st.alive.shape[0], _vp(ctl), int(max_steps),
                     _build.stream(dev))


def launch_slice_ctl(a: SliceArgs) -> None:
    """K9 on a CUDA batch: commit the slice loop's control word."""
    _build.check(_fn("slice", "mt_slice_ctl")(*a.argv), "slice_ctl", "slice")


class MeshArgs:
    """The steal kernel (K10/K11, ``csrc/mesh.cu``) on one batch over
    ``n`` shards: the plane struct and the plan buffers, checked and
    built once per loop (the fused mesh loop launches it every round on
    the same batch).

    ``export_`` u8[L] and ``buf_pos`` i32[L] are the plan per lane,
    ``sh`` i32[3n] the shard columns [occ, alive_c, filled], ``mctl``
    i32[4] = [do_steal, moved, steal_events, steal_lanes]."""

    def __init__(self, st: StateBatch, n: int, ctl=None):
        dev = st.pc.device
        L = st.pc.shape[0]
        if n < 1 or n > MESH_MAX_SHARDS or L % n:
            raise _build.KernelError(f"{L} lanes do not split into {n} shards (at most {MESH_MAX_SHARDS})")
        if L > MESH_MAX_LANES:
            raise _build.KernelError(f"the steal kernel takes at most {MESH_MAX_LANES} lanes, not {L}")
        if ctl is not None:
            _checked(ctl, "ctl", torch.int32, dev)
        self.n = int(n)
        self.pl = planes(st, 1, st.visited.shape[1])
        self.export_ = torch.zeros(L, dtype=torch.uint8, device=dev)
        self.buf_pos = torch.zeros(L, dtype=torch.int32, device=dev)
        self.sh = torch.zeros(3 * n, dtype=torch.int32, device=dev)
        self.mctl = torch.zeros(4, dtype=torch.int32, device=dev)
        self.ctl = ctl
        self.argv = ((ctypes.byref(self.pl), self.n),
                     (_vp(self.export_), _vp(self.buf_pos), _vp(self.sh), _vp(self.mctl), _vp(ctl), NFIELDS,
                      _build.stream(dev)))


def launch_mesh_steal(a: MeshArgs, flags: int) -> None:
    """One launch of the steal kernel: with ``flags`` 0 the per-shard
    counts, MESH_PLAN the steal plan, MESH_MOVE alone the moves of the
    plan in ``a`` (ungated), MESH_STEAL_ROUND the fused loop's steal
    (plan, decide into mctl, move when it says so, count)."""
    head, tail = a.argv
    _build.check(_fn("mesh", "mt_mesh_steal")(*head, int(flags), *tail), "mesh_steal", "mesh")


def mesh_kernel_launches() -> dict:
    """The kernel launches ``csrc/mesh.cu`` has made in this process:
    ``steal`` (the steal kernel), ``deal`` (K12's kernel) and ``cards``
    (the cross-card exchange), counted in C where each launch is made."""
    out = (ctypes.c_longlong * 3)()
    _fn("mesh", "mt_mesh_launches")(ctypes.cast(out, ctypes.c_void_p))
    return {"steal": int(out[0]), "deal": int(out[1]), "cards": int(out[2])}


class DealScratch:
    """K12's scratch batch (a row for each lane that may move, so L rows
    of every plane) and its order buffer, allocated once per batch shape,
    device and stream (as ``Scratch``) and kept: the sync mesh loop deals
    a new batch of the same shape every round."""

    _cache = {}
    _lock = threading.Lock()

    def __init__(self, st: StateBatch):
        dev = st.pc.device
        self.scratch = StateBatch(*(torch.empty_like(x) for x in st))
        self.ps = planes(self.scratch, 1, st.visited.shape[1])
        self.order = torch.empty(st.pc.shape[0], dtype=torch.int32, device=dev)

    @classmethod
    def get(cls, st: StateBatch) -> "DealScratch":
        dev = st.pc.device
        key = (str(dev), _build.stream_key(dev), tuple((tuple(x.shape), x.dtype) for x in st))
        with cls._lock:
            if key not in cls._cache:
                cls._cache[key] = cls(st)
            return cls._cache[key]


def launch_mesh_deal(st: StateBatch, n: int) -> torch.Tensor:
    """K12: deal the running lanes of ``st`` round-robin over ``n`` lane
    blocks, in place, in one cooperative launch that moves only the rows
    whose slot changes (through the shape's kept scratch). Returns the
    deal's lane order (int32[L], the scratch's buffer, which the next
    deal of this shape overwrites)."""
    L = st.pc.shape[0]
    if n < 1 or n > MESH_MAX_SHARDS or L % n or L > MESH_MAX_LANES:
        raise _build.KernelError(f"K12 deals at most {MESH_MAX_LANES} lanes over 1-{MESH_MAX_SHARDS} shards that "
                                 f"divide them, not {L} over {n}")
    sc = DealScratch.get(st)
    pl = planes(st, 1, st.visited.shape[1])
    rc = _fn("mesh", "mt_mesh_deal")(ctypes.byref(pl), ctypes.byref(sc.ps), int(n), _vp(sc.order), NFIELDS,
                                      _build.stream(st.pc.device))
    _build.check(rc, "mesh_deal", "mesh")
    return sc.order


class CardPeers(ctypes.Structure):
    """Every card's gathered-count buffer and send batch (csrc/mesh.cuh)."""

    _fields_ = [("gath", ctypes.c_void_p * MESH_MAX_CARDS),
                ("send", (ctypes.c_void_p * NFIELDS) * MESH_MAX_CARDS)]


class CardArgs:
    """The cross-card exchange (``mesh_cards_kernel``, csrc/mesh.cu) on
    card ``card`` of a mesh of ``n`` shards over ``len(sends)`` cards: the
    card's batch ``st``, every card's send batch and gathered buffer
    (``gaths``, i32[2n] each), and the card's ``held`` (i32[2n]) and
    ``mctl`` (i32[4], as ``MeshArgs``), checked and built once per loop.
    The launches run on the stream current for ``st``'s device when this
    was built. A send batch has the card's row sizes and at least its
    lanes; the kernels copy rows in 16-byte units where every batch's
    planes are 16-byte aligned, which a fresh allocation is."""

    def __init__(self, st: StateBatch, n: int, card: int, sends, gaths, held, mctl, ctl=None, max_rounds: int = 0):
        dev = st.pc.device
        cards = len(sends)
        L = st.pc.shape[0]
        if not 1 <= cards <= MESH_MAX_CARDS or n % cards or n > MESH_MAX_SHARDS or L % (n // cards):
            raise _build.KernelError(f"{n} shards do not split over {cards} cards (at most {MESH_MAX_CARDS}) "
                                     f"and {L} lanes a card")
        if L > MESH_MAX_LANES:
            raise _build.KernelError(f"the exchange takes at most {MESH_MAX_LANES} lanes a card, not {L}")
        for t, name, numel in ((held, "held", 2 * n), (mctl, "mctl", 4)):
            _checked(t, name, torch.int32, dev)
            if t.numel() != numel:
                raise _build.KernelError(f"{name} must hold {numel} int32")
        if ctl is not None:
            _checked(ctl, "ctl", torch.int32, dev)
        CL = st.visited.shape[1]
        self.pl = planes(st, 1, CL)
        self.sd = planes(sends[card], 1, CL)
        self.peers = CardPeers()
        for k, (snd, g) in enumerate(zip(sends, gaths)):
            if g.dtype != torch.int32 or g.numel() != 2 * n or not g.is_contiguous():
                raise _build.KernelError("a gathered buffer must be a contiguous int32[2n]")
            self.peers.gath[k] = g.data_ptr()
            for f, x in enumerate(snd):
                if x.shape[1:] != getattr(st, StateBatch._fields[f]).shape[1:] or x.shape[0] < L:
                    raise _build.KernelError(f"send batch {k}'s {StateBatch._fields[f]} does not fit card {card}'s")
                if x.data_ptr() % 16:
                    raise _build.KernelError(f"send batch {k}'s {StateBatch._fields[f]} is not 16-byte aligned")
                self.peers.send[k][f] = x.data_ptr()
        self.keep = (st, sends, gaths, held, mctl, ctl)  # the tensors behind the pointers
        self.held, self.mctl, self.ctl = held, mctl, ctl
        self.n, self.card, self.cards, self.max_rounds = int(n), int(card), cards, int(max_rounds)
        self.dev = dev
        self.stream = _build.stream(dev) if dev.type == "cuda" else None


def launch_mesh_cards(a: CardArgs, mode: int, ctl=True) -> None:
    """One launch of the cross-card exchange on ``a``'s card in ``mode``
    (XC_COUNT, XC_PLAN, XC_PULL), under that card's device (its grid is
    sized for it). ``ctl`` False launches without the loop's control word
    (the count before a super-round's first round)."""
    c = a.ctl if ctl else None
    with torch.cuda.device(a.dev):
        rc = _fn("mesh", "mt_mesh_cards")(
            ctypes.byref(a.pl), ctypes.byref(a.sd), ctypes.byref(a.peers), a.n, a.card, a.cards, mode,
            _vp(a.held), _vp(a.mctl), _vp(c), a.max_rounds, NFIELDS, a.stream)
    _build.check(rc, "mesh_cards", "mesh")


def enable_peers(devices) -> None:
    """Let every distinct CUDA device of ``devices`` reach the others'
    memory; raises where a pair cannot (there is no host fallback)."""
    idx = sorted({torch.cuda.current_device() if torch.device(d).index is None else torch.device(d).index
                  for d in devices})
    if len(idx) < 2:
        return
    arr = (ctypes.c_int * len(idx))(*idx)
    rc = _fn("mesh", "mt_mesh_enable_peers")(ctypes.cast(arr, ctypes.c_void_p), len(idx))
    if rc:
        raise _build.KernelError(f"peer access between cards {idx} is not available: CUDA error {rc} "
                                 f"({_build.library('mesh').mt_error_string(rc).decode()})")
