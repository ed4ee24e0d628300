"""Single-buffer host<->device movement of a StateBatch: K6 and K7.

Replaces ``mythril_tpu/laser/tpu/transfer.py``. Both directions keep
the reference's byte layout (the ``StateBatch`` field order, raw
little-endian bytes of each plane, bools as 0/1 bytes), its tape-prefix
and alive-prefix slicing and its absent-group skipping, so the bytes
that cross the host link are the reference's:

- up: ``serialize_segments`` writes the shipped planes into one pinned
  host buffer behind a small segment table, one ``copy_`` takes it to
  the card, and K6 (``unpack``) writes every plane in full: the shipped
  prefix of each row, zeros past it, zeros for an absent group, and
  ``!= 0`` for bools;
- down: K7 (``pack``) gathers the small planes (``tape_len`` and
  ``alive`` among them) into one device buffer that comes back in one
  copy; after the host has read them, a second K7 gathers the bulky
  planes sliced to the used tape columns and the alive lane prefix, or,
  for a batch off the mesh tiers (compacted per shard), one lane bucket
  per shard block (``shard_lanes``: each plane is then one segment per
  block).

Kernels (``csrc/transfer.cu``): K6 and K7 are one launch each of the
same kernel over a table of segments (``XFER_SEG``, one copy each: rows
of a shipped prefix, zeros past it), built here in one vectorised pass
and passed by value in the launch's parameters. The grid is balanced
over the table's total 16-byte units, not one grid row per plane.
Bound on the H100: device-memory bytes (each plane's bytes read once
and written once); the host link is timed separately against a plain
pinned ``copy_``. On CPU tensors the plain twins (``unpack_plain``,
``pack_plain``) do the same with torch views.

The reference compiles one XLA variant per (tape bucket, absent groups)
pair and pins a single full-size variant on accelerators
(``monomorphic``). The port's kernels take the prefixes as launch
arguments, so there is no compile to amortise and the port always ships
the sliced layout.
"""

import ctypes
import logging

import numpy as np
import torch

from mythril_tpu_torch.laser.cuda import _build, convert, words
from mythril_tpu_torch.laser.cuda.batch import BatchConfig, StateBatch, batch_shapes
from mythril_tpu_torch.robustness import faults

log = logging.getLogger(__name__)

unpack_launches = 0  # K6 launches (CUDA path only)
pack_launches = 0  # K7 launches (CUDA path only)

# csrc/transfer.cuh XferSeg: one segment of a K6/K7 launch
XFER_SEG = np.dtype([
    ("src", "<u8"), ("dst", "<u8"), ("rows", "<u4"), ("w_out", "<u4"), ("w_in", "<u4"),
    ("w_copy", "<u4"), ("upr", "<u4"), ("flags", "<u4"), ("first", "<u4"), ("pad", "<u4"),
])
XFER_MAX_SEGS = 672  # csrc/transfer.cuh: the most segments a launch takes
XF_BOOL = 1
_XFER_LIMIT = 1 << 31  # a segment's bytes and a table's units stay below this

# planes the host-side consumers never read: rebuilt as zeros on the way
# down (a downloaded batch is never re-uploaded)
_SKIP_DOWN = ("tape_h1", "tape_h2")

# row-sliceable planes (the term tapes dominate the batch's bytes)
_TAPE_PLANES = (
    "tape_op", "tape_a", "tape_b", "tape_imm", "tape_h1", "tape_h2",
    "tape_meta",
)
_TAPE_BUCKETS = (16, 64, 256, 1024, 4096)

# skippable plane groups for the upload (one presence bit per group)
_UP_GROUPS = {
    "symbolic": (
        "stack_sym", "tape_op", "tape_a", "tape_b", "tape_imm", "tape_h1",
        "tape_h2", "tape_meta", "tape_len", "path_id", "path_sign",
        "path_meta", "path_len",
        "msym_off", "msym_id", "msym_used", "skey_sym", "sval_sym",
        "calldata_symbolic", "storage_symbolic", "cdsize_sym",
        "caller_sym", "callvalue_sym", "origin_sym", "balance_sym",
    ),
    "memory": ("memory", "mem_words"),
    "storage": ("storage_key", "storage_val", "storage_used"),
}
_GROUP_OF = {
    plane: group for group, planes in _UP_GROUPS.items() for plane in planes
}

# bulky planes deferred to the second (sized) fetch
_BIG_DOWN = (
    "stack",
    "stack_sym",
    "memory",
    "visited",
    "calldata",
    "storage_key",
    "storage_val",
    "tape_op",
    "tape_a",
    "tape_b",
    "tape_imm",
    "tape_meta",
)

# the reference's numpy dtype of every plane (dtypes do not depend on sizes)
_NP_DTYPES = {k: np.dtype(dt) for k, (_s, dt) in batch_shapes(BatchConfig()).items()}


# tape_imm is carried FLAT ([L, T*NDIGITS]); its per-row column count
# scales accordingly when slicing/padding the used-row prefix
def _tape_cols(name: str, rows: int) -> int:
    return rows * words.NDIGITS if name == "tape_imm" else rows


def _bucket(n: int, cap: int) -> int:
    for b in _TAPE_BUCKETS:
        if n <= b and b <= cap:
            return b
    return cap


def _lane_bucket(n: int, cap: int) -> int:
    """Smallest power-of-two lane count covering ``n`` (min 16, max
    ``cap``)."""
    b = 16
    while b < n:
        b <<= 1
    return min(b, cap)


def serialize_segments(arrays) -> np.ndarray:
    """Host side: raw little-endian bytes of ``arrays``, concatenated."""
    if not arrays:
        return np.zeros(0, np.uint8)
    return np.concatenate(
        [np.ascontiguousarray(a).view(np.uint8).ravel() for a in arrays]
    )


# -- K6: unpack ----------------------------------------------------------


class UpSeg:
    """One plane of an upload: its full shape and dtype, and the bytes
    per row shipped (``ship``; None = the plane is absent, all zeros)."""

    __slots__ = ("shape", "dtype", "ship", "src_off")

    def __init__(self, shape, dtype, ship, src_off):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.ship = ship
        self.src_off = src_off

    @property
    def rows(self) -> int:
        return self.shape[0] if self.shape else 1

    @property
    def full(self) -> int:
        n = int(np.prod(self.shape)) if self.shape else 1
        return n // self.rows * self.dtype.itemsize


def _up_spec(arrays_full_shapes):
    """[(array or None, full shape, dtype)] -> (segments, shipped arrays):
    shipped arrays are laid out back to back in their order."""
    segs, shipped, off = [], [], 0
    for arr, shape, dtype in arrays_full_shapes:
        if arr is None:
            segs.append(UpSeg(shape, dtype, None, -1))
            continue
        arr = np.ascontiguousarray(arr)
        rows = shape[0] if len(shape) else 1
        ship = arr.nbytes // rows if rows else 0
        segs.append(UpSeg(shape, dtype, ship, off))
        shipped.append(arr)
        off += arr.nbytes
    return segs, shipped


def unpack_plain(buf: torch.Tensor, segs) -> list:
    """Twin of K6: planes from the shipped bytes in ``buf`` (u8, any
    device). Each row gets its shipped prefix then zeros; bools ``!= 0``."""
    out = []
    for s in segs:
        tdt = convert.torch_dtype(s.dtype)
        full = torch.zeros((s.rows, s.full), dtype=torch.uint8, device=buf.device)
        if s.ship:
            seg = buf[s.src_off: s.src_off + s.rows * s.ship].view(s.rows, s.ship)
            full[:, : s.ship] = seg
        if s.dtype == np.bool_:
            plane = (full != 0).reshape(s.shape)
        else:
            plane = full.view(tdt).reshape(s.shape)
        out.append(plane)
    return out


def _xfer_table(src, dst, rows, w_out, w_in, w_copy, flags):
    """A K6/K7 table: per segment, ``rows`` rows of ``w_out`` bytes at
    ``dst``, row r's first ``w_copy`` bytes from ``src + r * w_in`` and
    zeros past them (``w_copy`` 0: all zeros). Segments whose rows lie
    back to back become one row, empty ones are dropped, and each gets
    its unit count's exclusive prefix (``first``): 16-byte units of a
    row where the addresses and widths are 16-byte aligned (``upr`` a
    row), else 16-byte pieces of the flat output done byte by byte
    (``upr`` 0). Returns (table, total units, the index of each kept
    segment in the input)."""
    src, dst, rows, w_out, w_in, w_copy, flags = (
        np.asarray(a, np.int64).reshape(-1) for a in (src, dst, rows, w_out, w_in, w_copy, flags)
    )
    n = rows * w_out
    keep = np.flatnonzero(n > 0)
    src, dst, rows, w_out, w_in, w_copy, flags, n = (
        a[keep] for a in (src, dst, rows, w_out, w_in, w_copy, flags, n)
    )
    zero = w_copy == 0
    flat = zero | ((w_in == w_out) & (w_copy == w_out))
    src = np.where(zero, 0, src)
    rows, w_out = np.where(flat, 1, rows), np.where(flat, n, w_out)
    w_in = np.where(zero, 0, np.where(flat, n, w_in))
    w_copy = np.where(flat & ~zero, n, w_copy)
    vec = ((dst % 16 == 0) & (src % 16 == 0)
           & ((rows == 1) | ((w_out % 16 == 0) & (w_in % 16 == 0) & (w_copy % 16 == 0))))
    upr = np.where(vec, (w_out + 15) // 16, 0)
    units = np.where(vec, rows * upr, (n + 15) // 16)
    ends = np.cumsum(units)
    total = int(ends[-1]) if len(ends) else 0
    if len(units) > XFER_MAX_SEGS:
        raise _build.KernelError(f"transfer: {len(units)} segments, a launch takes {XFER_MAX_SEGS}")
    if len(n) and (int(n.max()) >= _XFER_LIMIT or total >= _XFER_LIMIT):
        raise _build.KernelError("transfer: a segment or the table is past 2**31 bytes or units")
    tab = np.zeros(len(units), XFER_SEG)
    for name, col in (("src", src), ("dst", dst), ("rows", rows), ("w_out", w_out), ("w_in", w_in),
                      ("w_copy", w_copy), ("upr", upr), ("flags", flags), ("first", ends - units)):
        tab[name] = col
    return tab, total, keep


def _launch(tab: np.ndarray, total: int, dev) -> None:
    """One launch of ``mt_xfer`` (K6 or K7) on the current stream; the
    table travels in the launch's parameters."""
    from mythril_tpu_torch.laser.cuda import kernels

    rc = kernels._fn("transfer", "mt_xfer")(
        ctypes.c_void_p(tab.ctypes.data), len(tab), total, _build.stream(dev)
    )
    _build.check(rc, "mt_xfer", "transfer")


def _up_table(segs, planes, src_base: int):
    """K6's table: plane i from the shipped bytes at ``src_base +
    src_off`` (zeros when absent) into ``planes[i]``."""
    shipped = np.array([bool(s.ship) for s in segs], bool)
    ship = np.array([s.ship or 0 for s in segs], np.int64)
    return _xfer_table(
        np.where(shipped, src_base + np.array([s.src_off for s in segs], np.int64), 0),
        [t.data_ptr() for t in planes],
        [s.rows for s in segs],
        [s.full for s in segs],
        ship,
        ship,
        [XF_BOOL if s.dtype == np.bool_ else 0 for s in segs],
    )


class Staged:
    """An upload on the card before K6: the device buffer of shipped
    bytes, its segments, the planes K6 will fill and K6's table."""

    __slots__ = ("buf", "segs", "planes", "table", "total")

    def __init__(self, buf, segs, planes, table, total):
        self.buf, self.segs, self.planes, self.table, self.total = buf, segs, planes, table, total


def stage(arrays_full_shapes, dev) -> Staged:
    """Serialize into one pinned host buffer and start its one copy to
    the card; K6's table names the device buffer and the planes."""
    segs, shipped = _up_spec(arrays_full_shapes)
    planes = [
        torch.empty(s.shape, dtype=convert.torch_dtype(s.dtype), device=dev) for s in segs
    ]
    nbytes = sum(a.nbytes for a in shipped)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    hv = host.numpy()
    off = 0
    for a in shipped:
        hv[off: off + a.nbytes] = a.view(np.uint8).ravel()
        off += a.nbytes
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    buf.copy_(host, non_blocking=True)
    table, total, _kept = _up_table(segs, planes, buf.data_ptr())
    return Staged(buf, segs, planes, table, total)


def unpack(staged: Staged) -> list:
    """K6: write every plane of a staged upload in full."""
    if staged.total:
        global unpack_launches
        unpack_launches += 1
        _launch(staged.table, staged.total, staged.buf.device)
    return staged.planes


def upload(arrays_full_shapes, device="cuda") -> list:
    """One host->device copy plus one K6 launch: ``[(array or None, full
    shape, dtype)]`` -> full-size device planes. An array narrower than
    its full shape (a tape prefix) ships only its rows' prefix."""
    dev = _build.resolve_device(device)
    if dev.type == "cpu":
        segs, shipped = _up_spec(arrays_full_shapes)
        return unpack_plain(torch.from_numpy(serialize_segments(shipped)), segs)
    return unpack(stage(arrays_full_shapes, dev))


def upload_segments(arrays, device="cuda"):
    """One-buffer upload of arbitrary host arrays; returns the device
    tensors (u32 arrays as int32 tensors with the same bits)."""
    return upload([(a, a.shape, a.dtype) for a in arrays], device)


def pool_to_device(pool, device="cuda"):
    """Pin the in-loop CNF pool (inloop_solve.InloopPool, host tensors)
    on the card once per super-round, through the same one-copy path."""
    from mythril_tpu_torch.laser.cuda.inloop_solve import InloopPool

    faults.fire(faults.TRANSFER_UP, context="pool_to_device")
    dev = _build.resolve_device(device)
    if all(t.device.type == dev.type for t in pool):
        return pool
    arrays = [
        convert.to_numpy(getattr(pool, f), convert.POOL_DTYPES[f]) for f in InloopPool._fields
    ]
    return InloopPool(*upload_segments(arrays, dev))


def batch_parts(np_batch: dict, cfg) -> list:
    """What ``batch_to_device`` ships: ``[(array or None, full shape,
    dtype)]`` in field order. Plane groups with no content are absent
    (rebuilt as zeros on the card) and the term-tape planes keep only
    their used row prefix."""
    shapes = batch_shapes(cfg)
    t_used = _bucket(int(np_batch["tape_len"].max()), cfg.tape_slots)
    absent = tuple(
        sorted(
            group
            for group, planes in _UP_GROUPS.items()
            if not any(np_batch[p].any() for p in planes)
        )
    )
    parts = []
    for name, (shape, dtype) in shapes.items():
        if _GROUP_OF.get(name) in absent:
            parts.append((None, shape, dtype))
            continue
        arr = np_batch[name]
        if name in _TAPE_PLANES:
            arr = arr[:, : _tape_cols(name, t_used)]
        parts.append((arr, shape, dtype))
    return parts


def batch_to_device(np_batch: dict, cfg, device="cuda") -> StateBatch:
    """Host plane dict -> device StateBatch via one upload (a freshly
    packed batch is mostly zeros, so the payload is typically a few
    hundred KB instead of the full batch)."""
    faults.fire(faults.TRANSFER_UP, context="batch_to_device")
    return StateBatch(*upload(batch_parts(np_batch, cfg), device))


# -- K7: pack ------------------------------------------------------------


def _down_cut(x: torch.Tensor, name: str, t_used, l_used):
    """(rows, shipped bytes per row, source row stride in bytes)."""
    rows = x.shape[0] if l_used is None else l_used
    row_elems = x[0].numel() if x.dim() > 1 else 1
    ship_elems = row_elems
    if t_used is not None and name in _TAPE_PLANES:
        ship_elems = _tape_cols(name, t_used) * (row_elems // x.shape[1])
    isz = x.element_size()
    return rows, ship_elems * isz, row_elems * isz


def _shard_cut(x: torch.Tensor, shard_lanes) -> torch.Tensor:
    """The first ``lb`` lanes of each of ``n`` blocks, side by side."""
    n, lb = shard_lanes
    rest = tuple(x.shape[1:])
    return x.reshape((n, x.shape[0] // n) + rest)[:, :lb].reshape((n * lb,) + rest)


def pack_plain(st: StateBatch, fields, t_used=None, l_used=None, shard_lanes=None) -> torch.Tensor:
    """Twin of K7: the named planes, sliced, as one u8 tensor."""
    parts = []
    for name in fields:
        x = getattr(st, name)
        if t_used is not None and name in _TAPE_PLANES:
            x = x[:, : _tape_cols(name, t_used)]
        if l_used is not None:
            x = x[:l_used]
        elif shard_lanes is not None:
            x = _shard_cut(x, shard_lanes)
        x = x.contiguous()
        parts.append(x.view(torch.uint8).reshape(-1) if x.dtype != torch.bool
                     else x.to(torch.uint8).reshape(-1))
    if not parts:
        return torch.zeros(0, dtype=torch.uint8, device=st.alive.device)
    return torch.cat(parts)


class _PackPlan:
    """What a K7 call's table takes from the planes' shapes and the cuts
    alone, kept per (fields, cuts, shapes): per (plane, lane block)
    segment its plane, its offset in the plane, rows, shipped and source
    row bytes and its offset in the output; and the table itself for
    16-byte-aligned planes and output, short of its addresses."""

    __slots__ = ("field", "rel", "rows", "ship", "srow", "off", "nbytes", "table", "total", "kept")

    def __init__(self, xs, fields, t_used, l_used, shard_lanes):
        n, lb = shard_lanes if shard_lanes is not None else (1, None)
        cols = np.zeros((4, len(fields)), np.int64)  # rows, ship, srow, block stride
        for i, (name, x) in enumerate(zip(fields, xs)):
            if not x.is_contiguous():
                raise _build.KernelError(f"pack: plane {name} is not contiguous")
            rows, ship, srow = _down_cut(x, name, t_used, l_used)
            cols[:, i] = (rows if lb is None else lb, ship, srow, x.shape[0] // n * srow)
        self.rows, self.ship, self.srow, stride = (np.repeat(c, n) for c in cols)
        self.field = np.repeat(np.arange(len(fields)), n)
        self.rel = np.tile(np.arange(n, dtype=np.int64), len(fields)) * stride
        nbytes = self.rows * self.ship
        self.off = np.cumsum(nbytes) - nbytes
        self.nbytes = int(nbytes.sum())
        # the table at 16-byte-aligned stand-in addresses: the real call's
        # differs only in its addresses when its own are aligned too
        base = (self.field + 1) << 32
        self.table, self.total, self.kept = _xfer_table(base + self.rel, (1 << 32) + self.off, self.rows, self.ship,
                                                    self.srow, self.ship, np.zeros_like(self.rows))


_PACK_PLANS = {}


def _pack_plan(st: StateBatch, fields, t_used=None, l_used=None, shard_lanes=None):
    """K7's plan for these planes and cuts (cached), and the planes'
    addresses."""
    xs = [getattr(st, name) for name in fields]
    key = (tuple(fields), t_used, l_used, shard_lanes, tuple([(x.shape, x.dtype, x.is_contiguous()) for x in xs]))
    plan = _PACK_PLANS.get(key)
    if plan is None:
        if len(_PACK_PLANS) >= 256:
            _PACK_PLANS.clear()
        plan = _PACK_PLANS[key] = _PackPlan(xs, fields, t_used, l_used, shard_lanes)
    return plan, np.array([x.data_ptr() for x in xs], np.int64)


def _pack_table(plan: _PackPlan, ptrs: np.ndarray, out_base: int):
    """K7's table for ``plan`` over planes at ``ptrs``, into
    ``out_base``: the plan's table with its addresses filled in, or,
    where a plane or the output is not 16-byte aligned, built anew."""
    if (ptrs & 15).any() or out_base & 15:
        src = ptrs[plan.field] + plan.rel
        return _xfer_table(src, out_base + plan.off, plan.rows, plan.ship, plan.srow, plan.ship,
                           np.zeros_like(plan.rows))[:2]
    table = plan.table.copy()
    table["src"] = ptrs[plan.field[plan.kept]] + plan.rel[plan.kept]
    table["dst"] = out_base + plan.off[plan.kept]
    return table, plan.total


def pack(st: StateBatch, fields, t_used=None, l_used=None, shard_lanes=None) -> torch.Tensor:
    """K7 on a card batch (the twin on a CPU batch). With ``shard_lanes``
    = (n, lb) each plane ships the first ``lb`` lanes of each of its
    ``n`` lane blocks, one segment per block."""
    dev = st.alive.device
    if dev.type == "cpu":
        return pack_plain(st, fields, t_used, l_used, shard_lanes)
    plan, ptrs = _pack_plan(st, fields, t_used, l_used, shard_lanes)
    out = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
    table, total = _pack_table(plan, ptrs, out.data_ptr())
    if total:
        global pack_launches
        pack_launches += 1
        _launch(table, total, dev)
    return out


def _fetch(buf: torch.Tensor) -> np.ndarray:
    """Device u8 buffer -> host numpy, through one pinned copy."""
    if buf.device.type == "cpu":
        return buf.numpy()
    host = torch.empty(buf.numel(), dtype=torch.uint8, pin_memory=True)
    with _build.sync_point():
        host.copy_(buf, non_blocking=True)
        torch.cuda.current_stream(buf.device).synchronize()
    return host.numpy()


def _unpack_host(buf: np.ndarray, shapes) -> dict:
    planes = {}
    off = 0
    for name, shape, dtype in shapes:
        nbytes = int(np.prod(shape)) * dtype.itemsize
        planes[name] = buf[off : off + nbytes].view(dtype).reshape(shape)
        off += nbytes
    return planes


def down_plan(tape_len: np.ndarray, alive: np.ndarray, cap: int):
    """(t_used, l_used) of the second fetch from the first one's planes:
    the tape bucket over the observed maximum, and a lane bucket when
    compaction left the alive lanes as a dense prefix (None = all)."""
    L = int(alive.shape[0])
    t_used = _bucket(int(tape_len.max()), cap)
    n_alive = int(alive.sum())
    if n_alive < L and not alive[n_alive:].any():
        lb = _lane_bucket(n_alive, L)
        if lb < L:
            return t_used, lb
    return t_used, None


def shard_plan(alive: np.ndarray, n_shards: int):
    """``(n_shards, lb)`` when every shard block of ``alive`` is a dense
    prefix (the mesh tiers' per-shard compaction) and a common lane
    bucket over the fullest block is smaller than a block, else None."""
    L = int(alive.shape[0])
    if n_shards < 2 or L % n_shards != 0:
        return None
    per = L // n_shards
    blocks = alive.reshape(n_shards, per)
    counts = blocks.sum(axis=1)
    if any(blocks[b, int(c):].any() for b, c in enumerate(counts)):
        return None
    lb = _lane_bucket(int(counts.max()), per)
    return (n_shards, lb) if lb < per else None


def batch_to_host(st: StateBatch, n_shards: int = 1) -> StateBatch:
    """Device StateBatch -> StateBatch of numpy planes (the reference's
    dtypes) in two downloads.

    Fetch 1 moves the small bookkeeping planes (including ``tape_len``);
    fetch 2 moves the bulky planes with the term-tape rows sliced to the
    observed maximum and, when compaction left the alive lanes as a dense
    prefix, only a power-of-two lane bucket over that prefix. ``n_shards
    > 1`` declares a batch off the mesh tiers, compacted per shard: when
    the whole batch is not a dense prefix, each shard block then ships
    one common lane bucket (``shard_plan``), as the reference does."""
    faults.fire(faults.TRANSFER_DOWN, context="batch_to_host")
    small = tuple(
        f
        for f in StateBatch._fields
        if f not in _SKIP_DOWN and f not in _BIG_DOWN
    )
    small_shapes = [(f, tuple(getattr(st, f).shape), _NP_DTYPES[f]) for f in small]
    planes = _unpack_host(_fetch(pack(st, small)), small_shapes)

    cap = int(st.tape_op.shape[1])
    L = int(st.alive.shape[0])
    alive = planes["alive"]
    t_used, l_used = down_plan(planes["tape_len"], alive, cap)
    n_alive = int(alive.sum())
    shard_lanes = None
    if not (n_alive < L and not alive[n_alive:].any()):
        shard_lanes = shard_plan(alive, n_shards)
    big_shapes = []
    for f in _BIG_DOWN:
        shape = tuple(getattr(st, f).shape)
        if f in _TAPE_PLANES:
            shape = (shape[0], _tape_cols(f, t_used)) + shape[2:]
        if l_used is not None:
            shape = (l_used,) + shape[1:]
        elif shard_lanes is not None:
            shape = (shard_lanes[0] * shard_lanes[1],) + shape[1:]
        big_shapes.append((f, shape, _NP_DTYPES[f]))
    planes.update(_unpack_host(_fetch(pack(st, _BIG_DOWN, t_used, l_used, shard_lanes)), big_shapes))
    # pad sliced tape planes back to capacity (rows at or past tape_len
    # are dead by invariant, so zeros are equivalent)
    for f in _TAPE_PLANES:
        if f in planes and planes[f].shape[1] != _tape_cols(f, cap):
            full = np.zeros(
                (planes[f].shape[0], _tape_cols(f, cap)) + planes[f].shape[2:],
                planes[f].dtype,
            )
            full[:, : planes[f].shape[1]] = planes[f]
            planes[f] = full
    # pad lane-sliced planes back to full height (dead-suffix lanes are
    # equivalent to zeros for every host consumer); per-shard buckets go
    # back to their block's offset
    if l_used is not None:
        for f in _BIG_DOWN:
            if planes[f].shape[0] != L:
                full = np.zeros((L,) + planes[f].shape[1:], planes[f].dtype)
                full[: planes[f].shape[0]] = planes[f]
                planes[f] = full
    elif shard_lanes is not None:
        n, lb = shard_lanes
        per = L // n
        for f in _BIG_DOWN:
            got = planes[f]
            full = np.zeros((L,) + got.shape[1:], got.dtype)
            for b in range(n):
                full[b * per : b * per + lb] = got[b * lb : (b + 1) * lb]
            planes[f] = full
    for name in _SKIP_DOWN:
        planes[name] = np.zeros(tuple(getattr(st, name).shape), _NP_DTYPES[name])
    return StateBatch(**planes)
