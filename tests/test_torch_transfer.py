"""The single-buffer StateBatch transport (K6 unpack, K7 pack) against
the JAX reference's transfer.py.

The reference's round-trip cases (tests/laser/test_transfer.py: full,
tape-sliced, groups skipped, the monomorphic override and the packed
frontier property) run through both packages on the same numpy planes:
the bytes that would cross the host link (the upload buffer and both
download buffers) and the planes on each side must be the reference's
bit for bit. The kernels' per-segment source, compiled as host C++,
must equal the plain twins."""

import ctypes

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


def roundtrip_both(monkeypatch, cfg: dict, np_batch: dict):
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
    assert np.array_equal(port_log["up"][0], ref_log["up"][0])
    assert len(ref_log["down"]) == len(port_log["down"]) == 2
    for r, p in zip(ref_log["down"], port_log["down"]):
        assert np.array_equal(p, r)


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
    # the full-size layout, pinned by the environment for both packages
    monkeypatch.setenv("MYTHRIL_TPU_MONO_TRANSFER", "1")
    ref_transfer._MONO.clear()
    cfg = dict(small_cfg(), tape_slots=64)
    roundtrip_both(monkeypatch, cfg, random_batch(cfg, tape_len=5))
    roundtrip_both(monkeypatch, cfg, random_batch(cfg, zero_groups=("symbolic",)))
    ref_transfer._MONO.clear()


def test_monomorphic_env_override(monkeypatch):
    assert port_transfer.monomorphic() is False  # no compile to amortise on any device
    monkeypatch.setenv("MYTHRIL_TPU_MONO_TRANSFER", "1")
    assert port_transfer.monomorphic() is True
    monkeypatch.setenv("MYTHRIL_TPU_MONO_TRANSFER", "0")
    assert port_transfer.monomorphic() is False


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


def _emu(name):
    fn = getattr(_build.host_emulation(), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("case", ["full", "sliced", "absent"])
def test_kernel_source_equals_twins(case):
    """K6 and K7's per-segment code (csrc/transfer.cuh) as host C++, on
    host pointers, against unpack_plain and pack_plain."""
    cfg = dict(small_cfg(), tape_slots=64)
    nb = random_batch(cfg, tape_len=5 if case == "sliced" else None,
                      zero_groups=("memory",) if case == "absent" else (), seed=7)
    shapes = batch_shapes(BatchConfig(**cfg))
    t_used = 16 if case == "sliced" else cfg["tape_slots"]
    parts = []
    for name, (shape, dtype) in shapes.items():
        arr = nb[name]
        if case == "absent" and name in port_transfer._UP_GROUPS["memory"]:
            arr = None
        elif name in port_transfer._TAPE_PLANES:
            arr = arr[:, : port_transfer._tape_cols(name, t_used)]
        parts.append((arr, shape, dtype))
    buf_t, segs = convert.upload_to_torch(parts, "cpu")
    buf = buf_t.numpy()
    twin = port_transfer.unpack_plain(buf_t, segs)
    outs = [np.zeros(s.shape, s.dtype) for s in segs]

    class _Ptr:  # what _up_table reads off a plane
        def __init__(self, a):
            self.a = a

        def data_ptr(self):
            return self.a.ctypes.data

    table = np.ascontiguousarray(port_transfer._up_table(segs, [_Ptr(o) for o in outs]))
    assert _emu("emu_unpack")(buf.ctypes.data, table.ctypes.data, len(segs)) == 0
    for name, o, t in zip(shapes, outs, twin):
        assert np.array_equal(o, convert.to_numpy(t, o.dtype)), name
    # K7 over the unpacked planes, tape columns and lanes sliced
    st = StateBatch(*twin)
    fields = port_transfer._BIG_DOWN + ("alive", "tape_len")
    l_used = 4 if case != "full" else None
    plain = port_transfer.pack_plain(st, fields, t_used, l_used).numpy()
    tab = np.zeros((len(fields), port_transfer.SEG_COLS), np.int64)
    off = 0
    keep = []
    for i, name in enumerate(fields):
        x = getattr(st, name).contiguous()
        keep.append(x)
        rows, ship, srow = port_transfer._down_cut(x, name, t_used, l_used)
        tab[i] = (x.data_ptr(), off, rows, ship, srow, 0)
        off += rows * ship
    out = np.zeros(off, np.uint8)
    assert _emu("emu_pack")(out.ctypes.data, tab.ctypes.data, len(fields)) == 0
    assert np.array_equal(out, plain)
