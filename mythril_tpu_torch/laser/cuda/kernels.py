"""ctypes plumbing shared by the kernel wrappers (K1, K3, K4).

The C side (``csrc/common.cuh``) takes the StateBatch as one ``Planes``
struct: a pointer and a row size in bytes per plane, in
``StateBatch._fields`` order, plus the batch's dimensions. The wrappers
in engine.py, inloop_solve.py and megakernel.py check devices, dtypes and
contiguity here before any pointer reaches a kernel.
"""

import ctypes

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
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return t


def planes(st: StateBatch, n_codes: int, code_len: int) -> Planes:
    from mythril_tpu_torch.laser.cuda import convert

    dev = st.pc.device
    L = st.pc.shape[0]
    D = 16
    pl = Planes()
    for i, name in enumerate(StateBatch._fields):
        t = _checked(getattr(st, name), name, convert.torch_dtype(_DTYPES[name]), dev)
        if t.shape[0] != L:
            raise ValueError(f"{name} is not lane-major")
        pl.p[i] = t.data_ptr()
        pl.row_bytes[i] = t[0].numel() * t.element_size() if t.dim() > 1 else t.element_size()
    if st.visited.shape[1] != code_len:
        raise ValueError("visited width differs from the code bank's code_len")
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
    """Per-(device, L) scratch buffers for the step and the epilogue."""

    _cache = {}

    def __init__(self, dev, L):
        self.tab = op_tables(dev)
        self.slot = torch.empty(L, dtype=torch.int32, device=dev)
        self.fork_do = torch.empty(L, dtype=torch.uint8, device=dev)
        self.fork_dest = torch.empty(L, dtype=torch.int32, device=dev)
        self.sha_active = torch.zeros(L, dtype=torch.uint8, device=dev)
        self.sha_off = torch.zeros(L, dtype=torch.int32, device=dev)
        self.sha_avail = torch.zeros(L, dtype=torch.int32, device=dev)
        self.sha_len = torch.zeros(L, dtype=torch.int32, device=dev)
        self.sha_digest = torch.zeros((L, 32), dtype=torch.uint8, device=dev)
        self.order = torch.empty(L, dtype=torch.int32, device=dev)
        self.dying = torch.empty(L, dtype=torch.uint8, device=dev)

    @classmethod
    def get(cls, dev, L):
        key = (str(dev), L)
        if key not in cls._cache:
            cls._cache[key] = cls(dev, L)
        return cls._cache[key]


LANE_THREADS = 64
_FNS = {}
_P = ctypes.POINTER
_V = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    ("step", "mt_step_plan"): [_P(Planes), _P(Bank)] + [_V] * 7 + [_I, _V],
    ("step", "mt_step_lanes"): [_P(Planes), _P(Bank)] + [_V] * 6 + [_I, _I, _V],
    ("inloop", "mt_unsat_mask"): [_P(Planes), _P(Pool), _V, _V, _I, _V],
    ("megakernel", "mt_round_epilogue"): [_P(Planes), _P(Planes)] + [_V] * 7 + [_I, _I, _V],
}


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
    loop steps one batch in place, so its pointers never change."""

    def __init__(self, cb, st: StateBatch):
        dev = st.pc.device
        self.sc = Scratch.get(dev, st.pc.shape[0])
        self.pl = planes(st, cb.code.shape[0], cb.code.shape[1])
        self.bk = bank(cb)
        self.stream = _build.stream(dev)


def launch_step_plan(a: StepArgs, ctl=None) -> None:
    """K1's plan pass: fork ranks and the concrete-SHA3 windows."""
    sc = a.sc
    rc = _fn("step", "mt_step_plan")(
        ctypes.byref(a.pl), ctypes.byref(a.bk), _vp(sc.tab), _vp(sc.slot), _vp(sc.sha_active),
        _vp(sc.sha_off), _vp(sc.sha_avail), _vp(sc.sha_len), _vp(ctl), NFIELDS, a.stream)
    _build.check(rc, "step plan", "step")


def launch_step_lanes(a: StepArgs, ctl=None) -> None:
    """K1's lane and fork passes (after K2 filled sc.sha_digest)."""
    sc = a.sc
    rc = _fn("step", "mt_step_lanes")(
        ctypes.byref(a.pl), ctypes.byref(a.bk), _vp(sc.tab), _vp(sc.slot), _vp(sc.sha_digest),
        _vp(sc.fork_do), _vp(sc.fork_dest), _vp(ctl), NFIELDS, LANE_THREADS, a.stream)
    _build.check(rc, "step lanes", "step")


def launch_unsat(pool, st: StateBatch, ctl=None, out=None) -> torch.Tensor:
    """K3 on a CUDA batch; returns bool[L] (``out`` if given)."""
    dev = st.pc.device
    L = st.pc.shape[0]
    if out is None:
        out = torch.zeros(L, dtype=torch.bool, device=dev)
    _checked(out, "out", torch.bool, dev)
    pl = planes(st, 1, st.visited.shape[1])
    ps = pool_struct(pool)
    if ps.V > 256:
        raise ValueError("unsat_mask kernel takes at most 256 pool variables")
    rc = _fn("inloop", "mt_unsat_mask")(ctypes.byref(pl), ctypes.byref(ps), _vp(out), _vp(ctl),
                                         NFIELDS, _build.stream(dev))
    _build.check(rc, "unsat_mask", "inloop")
    return out


def launch_epilogue(cb, st, unsat, acc, pv, ctl, max_rounds, scratch) -> None:
    """K4 on a CUDA batch: prune/kill/fold/compact in place."""
    dev = st.pc.device
    L = st.pc.shape[0]
    sc = Scratch.get(dev, L)
    n_codes, CL = cb.code.shape
    pl = planes(st, n_codes, CL)
    ps = planes(scratch, n_codes, CL)
    _checked(unsat, "unsat", torch.bool, dev)
    _checked(acc, "acc", torch.int32, dev)
    _checked(pv, "pruned_visited", torch.bool, dev)
    _checked(ctl, "ctl", torch.int32, dev)
    if pv.shape != (n_codes, CL) or ctl.numel() != 4 or acc.numel() != 4:
        raise ValueError("bad pruned_visited / ctl / acc shape")
    rc = _fn("megakernel", "mt_round_epilogue")(
        ctypes.byref(pl), ctypes.byref(ps), _vp(cb.prune_revert), _vp(unsat), _vp(acc),
        _vp(sc.order), _vp(sc.dying), _vp(pv), _vp(ctl), int(max_rounds), NFIELDS,
        _build.stream(dev))
    _build.check(rc, "round_epilogue", "megakernel")
