"""The single-buffer StateBatch transport (K6 unpack, K7 pack) against
the JAX reference's transfer.py.

The reference's round-trip cases (tests/laser/test_transfer.py: full,
tape-sliced, groups skipped, the monomorphic override and the packed
frontier property) run through both packages on the same numpy planes:
the bytes that would cross the host link (the upload buffer and both
download buffers) and the planes on each side must be the reference's
bit for bit. The port has no monomorphic layout (its kernels take the
prefixes as launch arguments): against the reference's, pinned on the
reference side alone, the planes must agree and the port must ship the
sliced bytes. The kernels' source, compiled as host C++ and run as the
card's grid runs it (several blocks of several threads, in either order),
must equal the plain twins byte for byte, on every case of
``test_kernel_source_equals_twins``."""

import ctypes
import types

import numpy as np
import pytest
import torch

from mythril_tpu.laser.tpu import transfer as ref_transfer
from mythril_tpu.laser.tpu.batch import BatchConfig as RefBatchConfig
from mythril_tpu.laser.tpu.batch import batch_shapes as ref_batch_shapes
from mythril_tpu_torch.laser.cuda import _build, convert
from mythril_tpu_torch.laser.cuda import transfer as port_transfer
from mythril_tpu_torch.laser.cuda.batch import BatchConfig, StateBatch, batch_shapes


def small_cfg():
    return dict(lanes=8, stack_slots=8, memory_bytes=64, calldata_bytes=32, storage_slots=4,
                code_len=64, tape_slots=16, path_slots=8, mem_sym_slots=4)


def random_batch(cfg: dict, tape_len=None, zero_groups=(), seed=1):
    """The reference test's random planes (rows past ``tape_len`` zeroed,
    ``zero_groups`` emptied)."""
    rng = np.random.default_rng(seed)
    zero_planes = {p for g in zero_groups for p in ref_transfer._UP_GROUPS[g]}
    np_batch = {}
    for name, (shape, dtype) in ref_batch_shapes(RefBatchConfig(**cfg)).items():
        if name in zero_planes:
            np_batch[name] = np.zeros(shape, dtype)
        elif dtype == np.bool_:
            np_batch[name] = rng.integers(0, 2, shape).astype(bool)
        else:
            np_batch[name] = rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype)
    if tape_len is not None and "symbolic" not in zero_groups:
        np_batch["tape_len"] = np.full((cfg["lanes"],), tape_len, np.int32)
        for f in ref_transfer._TAPE_PLANES:
            np_batch[f][:, tape_len * (16 if f == "tape_imm" else 1):] = 0
    return np_batch


def _capture(monkeypatch, module):
    """Record the upload buffer (serialize_segments' result) and every
    download buffer (_unpack_host's input) of one package."""
    log = {"up": [], "down": []}
    ser, unp = module.serialize_segments, module._unpack_host

    def serialize(arrays):
        out = ser(arrays)
        log["up"].append(np.array(out))
        return out

    def unpack_host(buf, shapes):
        log["down"].append(np.array(buf))
        return unp(buf, shapes)

    monkeypatch.setattr(module, "serialize_segments", serialize)
    monkeypatch.setattr(module, "_unpack_host", unpack_host)
    return log


def roundtrip_both(monkeypatch, cfg: dict, np_batch: dict, same_bytes=True):
    ref_log = _capture(monkeypatch, ref_transfer)
    port_log = _capture(monkeypatch, port_transfer)
    ref_st = ref_transfer.batch_to_device(np_batch, RefBatchConfig(**cfg))
    port_st = port_transfer.batch_to_device(np_batch, BatchConfig(**cfg), device="cpu")
    dtypes = {k: dt for k, (_s, dt) in batch_shapes(BatchConfig(**cfg)).items()}
    for name, arr in np_batch.items():
        ref_plane = np.asarray(getattr(ref_st, name))
        port_plane = convert.to_numpy(getattr(port_st, name), dtypes[name])
        assert np.array_equal(ref_plane, arr), name
        assert port_plane.dtype == ref_plane.dtype and np.array_equal(port_plane, ref_plane), name
    ref_back = ref_transfer.batch_to_host(ref_st)
    port_back = port_transfer.batch_to_host(port_st)
    for name, arr in np_batch.items():
        r, p = getattr(ref_back, name), getattr(port_back, name)
        assert p.dtype == r.dtype and np.array_equal(p, r), name
        if name in port_transfer._SKIP_DOWN:
            assert not np.any(p)
        else:
            assert np.array_equal(p, arr), name
    assert len(ref_log["up"]) == len(port_log["up"]) == 1
    assert len(ref_log["down"]) == len(port_log["down"]) == 2
    if not same_bytes:
        return ref_log, port_log
    assert np.array_equal(port_log["up"][0], ref_log["up"][0])
    for r, p in zip(ref_log["down"], port_log["down"]):
        assert np.array_equal(p, r)
    return ref_log, port_log


def test_roundtrip_full(monkeypatch):
    cfg = small_cfg()
    roundtrip_both(monkeypatch, cfg, random_batch(cfg))


def test_roundtrip_tape_sliced(monkeypatch):
    cfg = dict(small_cfg(), tape_slots=64)
    roundtrip_both(monkeypatch, cfg, random_batch(cfg, tape_len=5))


@pytest.mark.parametrize("groups", [("symbolic",), ("memory", "storage"), ("memory", "storage", "symbolic")])
def test_roundtrip_groups_skipped(monkeypatch, groups):
    cfg = small_cfg()
    roundtrip_both(monkeypatch, cfg, random_batch(cfg, zero_groups=groups))


def test_roundtrip_alive_prefix(monkeypatch):
    """A compacted batch (dense alive prefix) ships a lane bucket."""
    cfg = dict(small_cfg(), lanes=64)
    nb = random_batch(cfg, tape_len=3)
    nb["alive"][:] = False
    nb["alive"][:10] = True
    ref_log = _capture(monkeypatch, ref_transfer)
    port_log = _capture(monkeypatch, port_transfer)
    ref_back = ref_transfer.batch_to_host(ref_transfer.batch_to_device(nb, RefBatchConfig(**cfg)))
    port_back = port_transfer.batch_to_host(port_transfer.batch_to_device(nb, BatchConfig(**cfg), device="cpu"))
    for name in nb:
        assert np.array_equal(getattr(port_back, name), getattr(ref_back, name)), name
    assert np.array_equal(port_log["down"][1], ref_log["down"][1])
    assert port_log["down"][1].nbytes < ref_log["up"][0].nbytes  # 16 of 64 lanes came back


def test_roundtrip_monomorphic(monkeypatch):
    # the reference's full-size layout, pinned on the reference side
    # alone: the planes agree, and the port ships fewer bytes
    monkeypatch.setattr(ref_transfer, "monomorphic", lambda: True)
    cfg = dict(small_cfg(), tape_slots=64)
    for nb in (random_batch(cfg, tape_len=5), random_batch(cfg, zero_groups=("symbolic",))):
        ref_log, port_log = roundtrip_both(monkeypatch, cfg, nb, same_bytes=False)
        assert port_log["up"][0].nbytes < ref_log["up"][0].nbytes
        assert port_log["down"][1].nbytes < ref_log["down"][1].nbytes
        assert np.array_equal(port_log["down"][0], ref_log["down"][0])  # the small planes are never sliced


def test_monomorphic_env_override(monkeypatch):
    """The port has no monomorphic override: the environment variable
    that pins the reference's full-size layout leaves the port's sliced."""
    cfg = dict(small_cfg(), tape_slots=64)
    nb = random_batch(cfg, tape_len=5)
    sliced = port_transfer.batch_parts(nb, BatchConfig(**cfg))
    monkeypatch.setenv("MYTHRIL_TPU_MONO_TRANSFER", "1")
    assert not hasattr(port_transfer, "monomorphic")
    pinned = port_transfer.batch_parts(nb, BatchConfig(**cfg))
    assert [p[0] is None or p[0].shape for p in pinned] == [p[0] is None or p[0].shape for p in sliced]
    assert pinned[port_transfer.StateBatch._fields.index("tape_op")][0].shape == (cfg["lanes"], 16)


def test_upload_segments_and_pool_match_reference():
    from mythril_tpu.laser.tpu import inloop_solve as ref_inloop
    from mythril_tpu_torch.laser.cuda import inloop_solve as port_inloop

    rng = np.random.default_rng(3)
    arrays = [
        rng.integers(-5, 5, (8, 64, 3)).astype(np.int32),
        rng.integers(0, 64, (8,)).astype(np.int32),
        rng.random((8, 64)) < 0.5,
        rng.integers(-1, 2, (8, 64)).astype(np.int8),
        rng.integers(0, 2**32, (5,), dtype=np.uint64).astype(np.uint32),
    ]
    ref = ref_transfer.upload_segments(arrays)
    port = port_transfer.upload_segments(arrays, device="cpu")
    for a, r, p in zip(arrays, ref, port):
        assert np.array_equal(convert.to_numpy(p, a.dtype), np.asarray(r))
    parts = dict(var_h1=arrays[4], var_h2=arrays[4][::-1].copy(), lit_var=arrays[0][0, :4, :2].copy(),
                 lit_neg=arrays[2][:4, :2].copy(), lit_used=arrays[2][4:, :2].copy())
    ref_pool = ref_transfer.pool_to_device(ref_inloop.make_pool(**parts))
    port_pool = port_transfer.pool_to_device(port_inloop.make_pool(**parts, device="cpu"), device="cpu")
    assert convert.pool_to_numpy(port_pool).keys() == ref_pool._asdict().keys()
    for name, arr in convert.pool_to_numpy(port_pool).items():
        assert np.array_equal(arr, np.asarray(getattr(ref_pool, name))), name


def test_packed_frontier_roundtrip_property():
    """States packed through the port's DeviceBridge (concrete and
    symbolic calldata lanes mixed, a job id) survive batch_to_device and
    batch_to_host bit-exactly on every downloaded plane."""
    from mythril_tpu_torch.disassembler.asm import assemble
    from mythril_tpu_torch.laser.cuda.bridge import DeviceBridge
    from mythril_tpu_torch.laser.evm.cfg import Node
    from mythril_tpu_torch.laser.evm.state.calldata import ConcreteCalldata, SymbolicCalldata
    from mythril_tpu_torch.laser.evm.strategy.basic import BreadthFirstSearchStrategy
    from mythril_tpu_torch.laser.evm.svm import LaserEVM
    from mythril_tpu_torch.laser.evm.transaction.transaction_models import (
        MessageCallTransaction,
        get_next_transaction_id,
    )
    from mythril_tpu_torch.smt import symbol_factory

    src = "PUSH1 0x00\nCALLDATALOAD\nPUSH2 :x\nJUMPI\nSTOP\nx:\nJUMPDEST\nPUSH1 0x04\nCALLDATALOAD\nPUSH1 0x00\nSSTORE\nSTOP"
    runtime = assemble(src).hex()
    n = len(runtime) // 2
    creation = assemble(
        f"PUSH2 {n}\nPUSH2 :code\nPUSH1 0x00\nCODECOPY\nPUSH2 {n}\nPUSH1 0x00\nRETURN\ncode:"
    ).hex() + runtime
    laser = LaserEVM(strategy=BreadthFirstSearchStrategy, transaction_count=1, execution_timeout=60,
                     max_depth=128)
    laser.sym_exec(creation_code=creation, contract_name="T")
    ws = laser.open_states[0]
    (address,) = ws._accounts.keys()
    account = ws[symbol_factory.BitVecVal(address, 256)]

    def message_state(calldata=None):
        tx_id = get_next_transaction_id()
        sender = symbol_factory.BitVecSym(f"sender_{tx_id}", 256)
        tx = MessageCallTransaction(
            world_state=ws, identifier=tx_id, gas_price=symbol_factory.BitVecVal(10, 256),
            gas_limit=8_000_000, origin=sender, caller=sender, callee_account=account,
            call_data=SymbolicCalldata(tx_id) if calldata is None else ConcreteCalldata(tx_id, list(calldata)),
            call_value=symbol_factory.BitVecSym(f"call_value{tx_id}", 256),
        )
        gs = tx.initial_global_state()
        gs.transaction_stack.append((tx, None))
        node = Node(gs.environment.active_account.contract_name)
        node.constraints = gs.world_state.constraints
        gs.world_state.transaction_sequence.append(tx)
        gs.node = node
        node.states.append(gs)
        return gs

    cfg = BatchConfig(lanes=8, stack_slots=16, memory_bytes=256, calldata_bytes=128, storage_slots=8,
                      code_len=256, tape_slots=64, path_slots=16, mem_sym_slots=8)
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        bridge = DeviceBridge(cfg, job_id=int(rng.integers(1, 9)), device="cpu")
        staged = 0
        for _ in range(int(rng.integers(2, cfg.lanes // 2 + 1))):
            if rng.integers(0, 2):
                cd = bytes(rng.integers(0, 256, int(rng.integers(0, 68)), dtype=np.uint8))
                bridge.stage(message_state(cd))
            else:
                bridge.stage(message_state())
            staged += 1
        _cb, st = bridge.finish()
        back = port_transfer.batch_to_host(st)
        for name in batch_shapes(cfg):
            down = getattr(back, name)
            if name in port_transfer._SKIP_DOWN:
                assert not np.any(down), name
            else:
                assert np.array_equal(down, bridge._np_batch[name]), (seed, name)
        assert (back.job_id[:staged] == bridge.job_id).all()
        assert (back.job_id[staged:] == 0).all()


# (blocks, threads, reverse): the grid the host emulation stands in for
_GRIDS = ((1, 32, 0), (3, 32, 1), (2, 96, 0), (7, 64, 1))
_PATTERN = 0xA5  # what every output holds before a run: a byte the kernel skips shows


def _emu_xfer(table, total, outs, check):
    """K6/K7's source (csrc/transfer.cuh, run as transfer.cu's grid) on
    host pointers, once per grid of ``_GRIDS``: ``outs`` (the tensors the
    table writes) are reset to a pattern before each run, and ``check``
    is called after it."""
    fn = _build.host_emulation().emu_xfer
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    table = np.ascontiguousarray(table)
    for blocks, threads, reverse in _GRIDS:
        for o in outs:
            o.view(torch.uint8).fill_(_PATTERN)
        assert fn(table.ctypes.data, len(table), total, blocks, threads, reverse) == 0
        check((blocks, threads, reverse))


def _raw(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _k6_equals_twin(parts):
    """K6 on ``parts`` ([(array or None, full shape, dtype)]) against
    ``unpack_plain``, byte for byte (bool planes included)."""
    buf_t, segs = convert.upload_to_torch(parts, "cpu")
    twin = port_transfer.unpack_plain(buf_t, segs)
    outs = [torch.empty(s.shape, dtype=convert.torch_dtype(s.dtype)) for s in segs]
    table, total, _kept = port_transfer._up_table(segs, outs, buf_t.data_ptr())

    def check(grid):
        for i, (o, t) in enumerate(zip(outs, twin)):
            assert np.array_equal(_raw(o), _raw(t)), (grid, i)

    _emu_xfer(table, total, outs, check)
    return table, twin


def _k7_equals_twin(st, fields, t_used=None, l_used=None, shard_lanes=None):
    """K7 on ``st`` against ``pack_plain``."""
    plain = port_transfer.pack_plain(st, fields, t_used, l_used, shard_lanes).numpy()
    plan, ptrs = port_transfer._pack_plan(st, fields, t_used, l_used, shard_lanes)
    assert plan.nbytes == plain.size
    out = torch.empty(plan.nbytes, dtype=torch.uint8)
    table, total = port_transfer._pack_table(plan, ptrs, out.data_ptr())
    # the cached plan's table, addresses filled in, is the table built anew
    fresh, fresh_total, _kept = port_transfer._xfer_table(
        ptrs[plan.field] + plan.rel, out.data_ptr() + plan.off, plan.rows, plan.ship, plan.srow, plan.ship,
        np.zeros_like(plan.rows))
    assert np.array_equal(table, fresh) and total == fresh_total

    def check(grid):
        assert np.array_equal(out.numpy(), plain), grid

    _emu_xfer(table, total, [out], check)
    return table


def _bool_bytes(rng, shape):
    """A bool array whose bytes are 0-255 (numpy keeps them as given)."""
    return rng.integers(0, 256, shape, dtype=np.uint8).view(np.bool_)


def _odd_batch(rng, planes):
    """A stand-in batch for K7: {name: (dtype, shape)} as CPU tensors,
    each starting one element past a 16-byte boundary (bools 0/1, as
    every bool plane of a batch on the card is: K7 copies bytes as they
    are)."""
    st = {}
    for name, (dt, shape) in planes.items():
        raw = rng.integers(0, 256, shape[:-1] + (shape[-1] * np.dtype(dt).itemsize,), dtype=np.uint8)
        x = torch.from_numpy(raw != 0 if dt == np.bool_ else raw.view(dt).copy())
        isz = x.element_size()
        mem = torch.empty(x.numel() * isz + 16 + isz, dtype=torch.uint8)
        head = -mem.data_ptr() % 16 + isz
        st[name] = mem[head: head + x.numel() * isz].view(x.dtype).view(x.shape)
        st[name].copy_(x)
        assert st[name].data_ptr() % 16 == isz
    return types.SimpleNamespace(alive=torch.ones(8, dtype=torch.bool), **st)


_CASES = ("full", "sliced", "absent", "shard_lanes", "bool_bytes", "one_byte_rows", "unaligned", "no_fields",
          "many_blocks")


@pytest.mark.parametrize("case", _CASES)
def test_kernel_source_equals_twins(case):
    """K6 and K7's source (csrc/transfer.cuh) as host C++, on host
    pointers, run as the grid runs it (several blocks of several
    threads, grid-stride, threads in either order, the table staged per
    block), against unpack_plain and pack_plain, byte for byte."""
    rng = np.random.default_rng(11)
    if case in ("one_byte_rows", "unaligned", "no_fields"):
        if case == "one_byte_rows":
            # rows of one shipped byte in wider rows, and 1-byte planes
            parts = [(rng.integers(0, 256, (8, 1), dtype=np.uint8), (8, 7), np.uint8),
                     (_bool_bytes(rng, (8, 1)), (8, 3), np.bool_),
                     (rng.integers(-128, 128, (8,), dtype=np.int8), (8,), np.int8),
                     (None, (8, 1), np.uint8)]
            st = _odd_batch(rng, {"tape_op": (np.uint8, (8, 16)), "tape_a": (np.bool_, (8, 5)),
                                  "tape_meta": (np.uint8, (8, 1))})
            fields, t_used, l_used = ("alive", "tape_op", "tape_a", "tape_meta"), 1, None
        elif case == "unaligned":
            # shipped prefixes that are no multiple of 16 bytes, source and
            # destination offsets off 16-byte alignment, a flat plane whose
            # last 16-byte unit is short
            parts = [(rng.integers(0, 256, (8, 3), dtype=np.uint8), (8, 3), np.uint8),
                     (rng.integers(0, 256, (8, 3), dtype=np.uint8), (8, 5), np.uint8),
                     (rng.integers(-2**31, 2**31, (8, 3), dtype=np.int32), (8, 5), np.int32),
                     (rng.integers(0, 2**32, (8, 5), dtype=np.uint32), (8, 8), np.uint32),
                     (_bool_bytes(rng, (8, 2)), (8, 6), np.bool_),
                     (rng.integers(0, 256, (8, 33), dtype=np.uint8), (8, 33), np.uint8)]
            st = _odd_batch(rng, {"tape_op": (np.int32, (8, 13)), "tape_meta": (np.uint8, (8, 37)),
                                  "calldata": (np.uint8, (8, 19))})
            fields, t_used, l_used = ("alive", "tape_op", "tape_meta", "calldata"), 5, 6
        else:
            parts, st, fields, t_used, l_used = [], _odd_batch(rng, {}), (), None, None
        table, _twin = _k6_equals_twin(parts)
        table7 = _k7_equals_twin(st, fields, t_used, l_used)
        if case == "unaligned":
            assert not table["upr"].all() and table["upr"].any() and not table7["upr"][1:].any()
        if case == "no_fields":
            assert len(table) == len(table7) == 0
        return
    # 16 lanes make every shipped plane a multiple of 16 bytes: the
    # sliced tape rows and the bool planes then take the 16-byte units
    cfg = dict(small_cfg(), tape_slots=64, lanes={"many_blocks": 64, "sliced": 16, "bool_bytes": 16}.get(case, 8))
    nb = random_batch(cfg, tape_len=5 if case in ("sliced", "shard_lanes") else None,
                      zero_groups=("memory",) if case == "absent" else (), seed=7)
    if case == "bool_bytes":
        for name, arr in nb.items():
            if arr.dtype == np.bool_:
                nb[name] = _bool_bytes(rng, arr.shape)
    shapes = batch_shapes(BatchConfig(**cfg))
    t_used = 16 if case in ("sliced", "shard_lanes") else cfg["tape_slots"]
    parts = []
    for name, (shape, dtype) in shapes.items():
        arr = nb[name]
        if case == "absent" and name in port_transfer._UP_GROUPS["memory"]:
            arr = None
        elif name in port_transfer._TAPE_PLANES:
            arr = arr[:, : port_transfer._tape_cols(name, t_used)]
        parts.append((arr, shape, dtype))
    table, twin = _k6_equals_twin(parts)
    if case == "bool_bytes":  # bool planes in 16-byte units, normalised a word at a time
        bools = (table["flags"] & port_transfer.XF_BOOL) > 0
        assert bools.sum() >= 8 and (table["upr"][bools] > 0).all()
    if case == "sliced":  # the sliced tape planes keep their rows, in 16-byte units
        assert (table["rows"] > 1).sum() == 7 and (table["upr"][table["rows"] > 1] > 0).all()
    if case == "many_blocks":  # one segment's units span several blocks' chunks
        assert table["upr"].max() * table["rows"].max() > 4 * 96 * 7
    st = StateBatch(*twin)
    fields = port_transfer._BIG_DOWN + ("alive", "tape_len")
    if case == "shard_lanes":
        table7 = _k7_equals_twin(st, fields, t_used, shard_lanes=(4, 1))
        assert len(table7) == 4 * len(fields)
    else:
        table7 = _k7_equals_twin(st, fields, t_used, 4 if case in ("sliced", "absent") else None)
        if case == "sliced":
            assert ((table7["rows"] > 1) & (table7["upr"] > 0)).sum() == 5


def test_xfer_table_limits():
    """A table past what one launch takes raises KernelError; it is not
    split or sent another way."""
    n = port_transfer.XFER_MAX_SEGS
    ones = np.ones(n, np.int64)
    table, total, _kept = port_transfer._xfer_table(16 * ones, 16 * ones, ones, 16 * ones, 16 * ones, 16 * ones,
                                                    0 * ones)
    assert len(table) == n and total == n and table.dtype.itemsize == 48
    ones = np.ones(n + 1, np.int64)
    with pytest.raises(_build.KernelError, match="segments"):
        port_transfer._xfer_table(16 * ones, 16 * ones, ones, 16 * ones, 16 * ones, 16 * ones, 0 * ones)
    with pytest.raises(_build.KernelError, match="2\\*\\*31"):
        port_transfer._xfer_table([16], [16], [1 << 16], [1 << 15], [1 << 15], [1 << 15], [0])
