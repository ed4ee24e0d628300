"""The fused mesh tier across several cards, on CPU "cards".

A mesh of n shards may span several cards (``mesh.Mesh.devices``), each
card holding n / cards contiguous shards as a batch of its own; a card
may repeat another's device, as the reference's tests run 8 virtual
devices of one host. Here every card is the CPU: the cross-card
super-round (``megakernel.run_fused_mesh`` over 2, 4 and 8 cards, the
exchange's twins) must equal the one-batch layout
(``run_fused_mesh_plain`` on the joined batch, which
test_torch_mesh_fused.py holds against the reference) bit for bit: every
plane at every lane, ``info``, ``pruned_visited`` and ``hist``; one case
is held against the reference's ``shard_map`` run directly. The
exchange's kernel (``mesh_cards_kernel``, ``csrc/mesh.cuh``) runs through
its host emulation, mode by mode and as the card loop launches it. The
analysis and a two-job shared round run over CPU cards, one card is
today's path, and the shard count follows the host's cards."""

import ctypes
import functools
import logging

import numpy as np
import pytest
import torch

import mythril_tpu_torch.laser.cuda.backend as backend
from mythril_tpu_torch.analysis.module.util import reset_callback_modules
from mythril_tpu_torch.analysis.security import fire_lasers
from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
from mythril_tpu_torch.disassembler.asm import assemble
from mythril_tpu_torch.ethereum.evmcontract import EVMContract
from mythril_tpu_torch.laser.cuda import _build, batch, inloop_solve, kernels, megakernel, mesh
from mythril_tpu_torch.laser.cuda import solver as port_solver
from mythril_tpu_torch.laser.cuda import solver_cache as port_solver_cache
from tests.test_torch_mesh_analyze import MESH_CFG, RUNTIME
from tests.test_torch_mesh_fused import CFG, COUNTDOWN_SRC, N_SHARDS, SPREAD, _assert_same, _becstress
from tests.test_torch_mesh_kernels import _emu_epilogue, _emu_k1, _shaped_batch, _vp

logging.getLogger().setLevel(logging.ERROR)

STEPS = 24  # rounds of 24 steps keep the per-card twins' step count small
SKEW_SRC = "here:\nJUMPDEST\nPUSH1 :here\nJUMP"


def _workload(name):
    """(code bank, batch, rounds): the countdown (eight lanes in shards
    0-3; a steal in the first round), the skew demo (4 spinning lanes)
    and becstress (its seeds spread so that a shard fills)."""
    if name == "becstress":
        code, kw, specs = _becstress()
    elif name == "countdown":
        code, kw = assemble(COUNTDOWN_SRC), {}
        specs = [dict(calldata=(lane * 7 + 1).to_bytes(32, "big"), gas=10_000_000) for lane in range(8)]
    else:
        code, kw, specs = assemble(SKEW_SRC), {}, [dict(calldata=b"", gas=10_000_000) for _ in range(4)]
    cb = batch.make_code_bank([code], CFG["code_len"], device="cpu", **kw)
    st = batch.build_batch(batch.BatchConfig(**CFG), specs, device="cpu")
    if name == "becstress":
        st = batch.StateBatch(*(x[torch.as_tensor(SPREAD)] for x in st))
    return cb, st, {"countdown": 2, "skew": 3, "becstress": 3}[name]


@functools.lru_cache(maxsize=None)
def _one_batch(name):
    cb, st, rounds = _workload(name)
    return megakernel.run_fused_mesh_plain(cb, st, N_SHARDS, rounds, STEPS, True, inloop_solve.empty_pool("cpu"),
                                           True)


def _cpu_cards(k):
    return mesh.make_mesh(N_SHARDS, device="cpu", cards=["cpu"] * k)


def _assert_batches(a, b, where):
    for name, x, y in zip(batch.StateBatch._fields, a, b):
        if not torch.equal(x, y):
            idx = tuple((x != y).nonzero()[0].tolist())
            raise AssertionError(f"{where}: {name}{list(idx)} cards={x[idx].item()} one batch={y[idx].item()}")


@pytest.mark.parametrize("cards", [2, 4, 8])
@pytest.mark.parametrize("name", ["countdown", "skew", "becstress"])
def test_cards_equal_the_one_batch_layout(name, cards):
    cb, st, rounds = _workload(name)
    want = _one_batch(name)
    m = _cpu_cards(cards)
    out = megakernel.run_fused_mesh(m, cb, None, st, max_rounds=rounds, steps_per_round=STEPS, with_stats=True,
                                    with_solve=True)
    assert isinstance(out.st, mesh.PerCard) and len(out.st) == cards
    assert all(p.pc.shape[0] == 16 // cards for p in out.st)
    _assert_batches(mesh.gather_batch(out.st, m), want.st, f"{name} over {cards} cards")
    assert out.info.tolist() == want.info.tolist()
    assert torch.equal(out.pruned_visited, want.pruned_visited) and torch.equal(out.hist, want.hist)
    stats = megakernel.decode_mesh_info(out.info, N_SHARDS)
    if name != "becstress":  # the shards were skewed: the exchange moved lanes between cards
        assert stats.steal_events >= 1 and stats.steal_lanes >= 2


def test_cards_equal_the_reference():
    """The countdown over 8 cards, one shard a card, against the
    reference's run_fused_mesh on its 8 virtual devices (the reference's
    test CFG, stats and the in-loop screen on; one compile)."""
    from mythril_tpu.laser.tpu import batch as rb
    from mythril_tpu.laser.tpu import megakernel as rm
    from mythril_tpu.laser.tpu import mesh as rmesh

    specs = [dict(calldata=(lane * 7 + 1).to_bytes(32, "big"), gas=10_000_000) for lane in range(8)]
    rm_ = rmesh.make_mesh(N_SHARDS)
    cb_r, env_r = rmesh.put_replicated((rb.make_code_bank([assemble(COUNTDOWN_SRC)], CFG["code_len"]),
                                        rb.default_env()), rm_)
    ro = rm.run_fused_mesh(rm_, cb_r, env_r, rmesh.shard_batch(rb.build_batch(rb.BatchConfig(**CFG), specs), rm_),
                           max_rounds=2, steps_per_round=STEPS, with_stats=True, with_solve=True)
    cb, st, rounds = _workload("countdown")
    m = _cpu_cards(8)
    po = megakernel.run_fused_mesh(m, cb, None, st, max_rounds=rounds, steps_per_round=STEPS, with_stats=True,
                                   with_solve=True)
    _assert_same(ro.st, mesh.gather_batch(po.st, m), "countdown over 8 cards")
    assert np.asarray(ro.info).tolist() == po.info.tolist()
    assert np.array_equal(np.asarray(ro.pruned_visited), po.pruned_visited.numpy())
    assert np.array_equal(np.asarray(ro.hist), po.hist.numpy().view(np.uint32))
    stats = megakernel.decode_mesh_info(po.info, N_SHARDS)
    assert stats.steal_events == 1 and stats.steal_lanes == 3


# -- the exchange -----------------------------------------------------------


def _split(st, cards):
    lc = st.pc.shape[0] // cards
    return [batch.StateBatch(*(x[k * lc:(k + 1) * lc].clone() for x in st)) for k in range(cards)]


def _steal_round_plain(st, n):
    """The one-batch layout's steal: plan, gate, apply (not compacted)."""
    plan = mesh.steal_plan_plain(st, n)
    go = int(plan.moved) > 0 and int(plan.occ.max()) - int(plan.occ.min()) > 1
    return (mesh.steal_apply_plain(st, plan, n) if go else st), go, int(plan.moved), plan


CASES = [(kind, L, n, cards) for kind in ("skew", "ragged", "sparse", "idle", "full_receivers")
         for L, n in ((64, 8), (160, 8), (512, 64), (64, 2)) for cards in (1, 2, 8) if n % cards == 0]


@pytest.mark.parametrize("kind,L,n,cards", CASES)
def test_exchange_twins_equal_steal_plan_and_apply(kind, L, n, cards):
    st = _shaped_batch(kind, L, n, seed=L + n + cards)
    want, go, moved, plan = _steal_round_plain(st, n)
    parts = _split(st, cards)
    counts = torch.cat([mesh.card_counts_plain(p, n // cards) for p in parts])
    assert counts[:, 0].tolist() == plan.occ.tolist() and counts[:, 1].tolist() == plan.alive_c.tolist()
    out, go_x, moved_x = mesh.exchange_plain(parts, n)
    assert (go_x, moved_x) == (go, moved)
    _assert_batches(mesh.gather_batch(out), want, f"{kind} L={L} n={n} cards={cards}")


def _emu_cards(lib, args, mode, nblocks=1, nthreads=None, reverse=0, ctl=True):
    a = args
    nthreads = nthreads or max(64, -(-a.keep[0].pc.shape[0] // 32) * 32)
    rc = lib.emu_mesh_cards(ctypes.byref(a.pl), ctypes.byref(a.sd), ctypes.byref(a.peers), a.n, a.card, a.cards,
                            mode, _vp(a.held), _vp(a.mctl), _vp(a.ctl if ctl else None), a.max_rounds, nblocks,
                            nthreads, reverse)
    assert rc == 0


def _exchange_args(parts, n, ctls=None, max_rounds=0, pattern=True):
    cards = len(parts)
    sends = [batch.StateBatch(*(torch.empty_like(x) for x in p)) for p in parts]
    if pattern:  # stale bytes everywhere (the loop's own start: zeroed counters): a read of an unwritten row shows
        for s in sends:
            for x in s:
                x.view(torch.uint8).fill_(0xA7) if x.dtype != torch.bool else x.fill_(True)
    gaths = [torch.full((2 * n,), -5 if pattern else 0, dtype=torch.int32) for _ in parts]
    helds = [torch.full((2 * n,), -6 if pattern else 0, dtype=torch.int32) for _ in parts]
    mctls = [torch.tensor([-3, -5, 11, 13] if pattern else [0] * 4, dtype=torch.int32) for _ in parts]
    ctls = ctls or [None] * cards
    return [kernels.CardArgs(p, n, k, sends, gaths, helds[k], mctls[k], ctls[k], max_rounds)
            for k, p in enumerate(parts)], gaths


EMU_CASES = [(kind, L, n, cards, grid, rev) for kind in ("skew", "ragged", "sparse", "full_receivers")
             for L, n, cards in ((64, 8, 2), (64, 8, 8), (512, 64, 8), (160, 8, 4))
             for grid, rev in (((1, None), 0), ((3, None), 1), ((2, 1024), 0))]


@pytest.mark.parametrize("kind,L,n,cards,grid,rev", EMU_CASES)
def test_exchange_kernel_logic_equals_twins(emu, kind, L, n, cards, grid, rev):
    """The three modes through the host emulation, on every card in turn
    (several blocks, both thread orders), against the twins: the counts
    in every card's gathered buffer, the decision and counters, the
    continue bit restaged from the mesh-wide total, each card's planes."""
    st = _shaped_batch(kind, L, n, seed=3 * L + n)
    want, go, moved, plan = _steal_round_plain(st, n)
    parts = _split(st, cards)
    ctls = [torch.tensor([4, 1, 5, 0], dtype=torch.int32) for _ in parts]  # round 4 staged 5, local bits 0
    args, gaths = _exchange_args(parts, n, ctls, max_rounds=9)
    nb, nt = grid
    for a in args:
        _emu_cards(emu, a, kernels.XC_COUNT, 1, None, rev)
    flat = torch.stack([plan.occ, plan.alive_c], 1).flatten().tolist()
    assert all(g.tolist() == flat for g in gaths)
    for a in args:
        _emu_cards(emu, a, kernels.XC_PLAN, nb, nt, rev)
    for a in args:
        _emu_cards(emu, a, kernels.XC_PULL, nb, nt, rev)
    _assert_batches(torch_join(parts), want, f"{kind} L={L} n={n} cards={cards}")
    running = int(plan.occ.sum())
    for a in args:
        assert a.mctl.tolist() == [int(go), moved, 11 + int(go), 13 + (moved if go else 0)]
        assert a.held.tolist() == flat
        assert a.ctl.tolist() == [4, 1, 5, int(running > 0)]


def torch_join(parts):
    return batch.StateBatch(*(torch.cat(planes) for planes in zip(*parts)))


def test_exchange_launches_nothing_once_the_loop_ended(emu):
    st = _shaped_batch("skew", 64, 8, seed=1)
    parts = _split(st, 2)
    before = [batch.StateBatch(*(x.clone() for x in p)) for p in parts]
    ctls = [torch.tensor([3, 0, 3, 0], dtype=torch.int32) for _ in parts]
    args, gaths = _exchange_args(parts, 8, ctls, max_rounds=9)
    for mode in (kernels.XC_COUNT, kernels.XC_PLAN, kernels.XC_PULL):
        for a in args:
            _emu_cards(emu, a, mode)
    _assert_batches(torch_join(parts), torch_join(before), "ended loop")
    assert all(g.tolist() == [-5] * 16 for g in gaths)
    assert all(a.mctl.tolist() == [-3, -5, 11, 13] for a in args)


def _emu_cards_loop(lib, cb, st, n, cards, rounds, steps, pool, with_stats):
    """``_run_fused_mesh_cards``'s card loop with the emulated kernels:
    the start (counts, each card's continue bit), then a round is K1, K3
    and K4 (staging) on each card, XC_COUNT on each, XC_PLAN on each,
    XC_PULL on each, K4 (gated compaction, commit) on each."""
    nl = n // cards
    parts = _split(st, cards)
    L = parts[0].pc.shape[0]
    ctls = [torch.zeros(4, dtype=torch.int32) for _ in parts]
    accs = [torch.zeros(4, dtype=torch.int32) for _ in parts]
    pvs = [torch.zeros(cb.code.shape, dtype=torch.bool) for _ in parts]
    hists = [torch.zeros(256 if with_stats else 1, dtype=torch.int32) for _ in parts]
    unsats = [torch.zeros(L, dtype=torch.bool) for _ in parts]
    scratch = [batch.StateBatch(*(torch.empty_like(x) for x in p)) for p in parts]
    args, gaths = _exchange_args(parts, n, ctls, rounds, pattern=False)
    for a in args:
        _emu_cards(lib, a, kernels.XC_COUNT, ctl=False)
    for k in range(cards):
        ctls[k][1] = int(int(gaths[k][0::2].sum()) > 0 and rounds > 0)
    for _ in range(rounds):
        for k, s in enumerate(parts):
            for x, y in zip(s, _emu_k1(lib, cb, s, nl, steps, ctl=ctls[k], hist=hists[k] if with_stats else None)):
                x.copy_(y)
            if ctls[k][1]:
                pl = kernels.planes(s, 1, cb.code.shape[1])
                assert lib.emu_unsat(ctypes.byref(pl), ctypes.byref(kernels.pool_struct(pool)), _vp(unsats[k]),
                                     0) == 0
            _emu_epilogue(lib, cb, s, scratch[k], unsats[k], accs[k], pvs[k], ctls[k], rounds, nl, 0)
        for mode in (kernels.XC_COUNT, kernels.XC_PLAN, kernels.XC_PULL):
            for a in args:
                _emu_cards(lib, a, mode, nblocks=2)
        for k, s in enumerate(parts):
            _emu_epilogue(lib, cb, s, scratch[k], unsats[k], accs[k], pvs[k], ctls[k], rounds, nl,
                          kernels.EPI_COMMIT | kernels.EPI_COMPACT_ONLY, args[k].mctl)
    acc = sum(accs[1:], accs[0])
    info = megakernel._mesh_info(ctls[0][0], acc, args[0].mctl[2], args[0].mctl[3], parts, n)
    pv = functools.reduce(torch.logical_or, pvs)
    return torch_join(parts), info, pv, sum(hists[1:], hists[0]), ctls


@pytest.mark.parametrize("cards", [2, 8])
@pytest.mark.parametrize("name", ["countdown", "skew"])
def test_emulated_card_loop_equals_the_one_batch_layout(emu, name, cards):
    cb, st, rounds = _workload(name)
    want = _one_batch(name)
    s, info, pv, hist, ctls = _emu_cards_loop(emu, cb, st, N_SHARDS, cards, rounds, STEPS,
                                              inloop_solve.empty_pool("cpu"), True)
    _assert_batches(s, want.st, f"{name} emulated over {cards} cards")
    assert info.tolist() == want.info.tolist()
    assert torch.equal(pv, want.pruned_visited) and torch.equal(hist, want.hist)
    assert all(c.tolist() == ctls[0].tolist() for c in ctls)  # every card ran the same rounds


@pytest.fixture(scope="module")
def emu():
    return _build.host_emulation()


# -- one card, and how many ------------------------------------------------


def test_one_card_is_todays_path(monkeypatch):
    m = mesh.make_mesh(N_SHARDS, device="cpu")
    assert m.cards == 1 and m.devices == (torch.device("cpu"),)
    cb, st, rounds = _workload("skew")
    on = mesh.shard_batch(st, m)
    assert isinstance(on, batch.StateBatch) and all(x is y for x, y in zip(on, st))  # no copy
    assert mesh.put_replicated(cb, m) == cb and all(x is y for x, y in zip(mesh.put_replicated(cb, m), cb))
    assert mesh.gather_batch(on, m) is on

    def no_cards(*a, **k):
        raise AssertionError("the one-card mesh took the cross-card path")

    monkeypatch.setattr(megakernel, "_run_fused_mesh_cards", no_cards)
    monkeypatch.setattr(mesh, "CardExchange", no_cards)
    out = megakernel.run_fused_mesh(m, cb, None, st, max_rounds=rounds, steps_per_round=STEPS, with_stats=True,
                                    with_solve=True)
    assert isinstance(out.st, batch.StateBatch)
    _assert_batches(out.st, _one_batch("skew").st, "one card")
    assert out.info.tolist() == _one_batch("skew").info.tolist()


@pytest.mark.parametrize("count", [1, 2, 8])
def test_shards_follow_the_cards(monkeypatch, count):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: True)
    mesh._mesh_cached.cache_clear()
    peers = []
    monkeypatch.setattr(kernels, "enable_peers", lambda devs: peers.append(tuple(devs)))
    monkeypatch.delenv("MYTHRIL_TPU_MESH", raising=False)
    monkeypatch.setattr(backend, "MESH_MODE", "auto")
    n = mesh.n_devices("cuda")
    assert n == count and mesh.n_devices("cpu") == 1
    tier = backend._mesh_tier(n, "cuda")
    m = mesh.make_mesh(device="cuda")
    if count == 1:
        assert tier == "off" and m.cards == 1 and m.devices == (torch.device("cuda"),) and not peers
    else:
        assert tier == "fused"
        assert m.n == count and m.cards == count  # one shard a card
        assert m.devices == tuple(torch.device("cuda", i) for i in range(count))
        assert peers == [m.devices]
        # a mesh of more shards than cards: as many cards as divide it
        assert mesh.make_mesh(12, device="cuda").cards == (2 if count == 2 else 6)


def test_cards_without_peer_access_stay_on_one_card(monkeypatch):
    """Two cards of which neither reaches the other (PCIe cards behind
    separate root complexes, many VMs): the host counts as one card, so
    "auto" runs the single-device tiers and makes no mesh; a third card
    that reaches only some of the first two stays out. An explicit cards
    list that names such a pair raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: False)

    def no_peers(devs):
        raise _build.KernelError(f"peer access between cards {list(devs)} is not available")

    monkeypatch.setattr(kernels, "enable_peers", no_peers)
    monkeypatch.delenv("MYTHRIL_TPU_MESH", raising=False)
    monkeypatch.setattr(backend, "MESH_MODE", "auto")
    monkeypatch.setattr(backend, "DEVICE", "cuda")
    mesh._mesh_cached.cache_clear()
    assert mesh.n_devices("cuda") == 1
    assert backend._device_mesh_tier() == (1, "off")
    assert mesh.card_devices(8, "cuda") == (torch.device("cuda"),)
    assert mesh.make_mesh(device="cuda").cards == 1 and mesh.make_mesh(8, device="cuda").cards == 1
    with pytest.raises(_build.KernelError, match="peer access"):
        mesh.make_mesh(2, device="cuda", cards=["cuda:0", "cuda:1"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: {a, b} == {0, 1})
    assert mesh.n_devices("cuda") == 2 and mesh.card_devices(8, "cuda") == (torch.device("cuda", 0),
                                                                            torch.device("cuda", 1))


def test_sync_tier_makes_no_peer_access(four_cpu_cards):
    """The sync mesh tier runs the whole batch on the first card, so it
    asks for no peer access: on a host whose default cards are two that
    cannot reach each other it still runs, and gives the one-card
    layout's round."""
    mp = four_cpu_cards
    mp.setattr(backend, "MESH_MODE", "sync")
    mp.setattr(mesh, "n_devices", lambda device="cuda": 8)
    cb, st, _ = _workload("countdown")
    cfg = batch.BatchConfig(**CFG)
    one, _ = backend._run_device(cb, st, cfg)

    def no_peers(devs):
        raise _build.KernelError(f"peer access between cards {list(devs)} is not available")

    mp.setattr(kernels, "enable_peers", no_peers)
    mp.setattr(mesh, "card_devices", lambda n, device="cuda": (torch.device("cuda", 0), torch.device("cuda", 1)))
    mesh._mesh_cached.cache_clear()
    out, _ = backend._run_device(cb, st, cfg)
    _assert_batches(out, one, "the sync tier beside cards without peer access")


def test_check_on_compares_the_card(monkeypatch):
    class T:
        def __init__(self, d):
            self.device = torch.device(d)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _build.check_on("cuda:1", T("cuda:1")) == torch.device("cuda", 1)
    assert _build.check_on("cuda", T("cuda:1"), T("cuda:0")).type == "cuda"
    with pytest.raises(_build.KernelError, match="cuda:0"):
        _build.check_on("cuda:1", T("cuda:1"), T("cuda:0"))


def test_missing_peer_access_raises(monkeypatch):
    class Fn:
        def __call__(self, devs, k):
            return 217  # cudaErrorPeerAccessUnsupported

    class Lib:
        @staticmethod
        def mt_error_string(code):
            return b"peer access is not supported between these two devices"

    monkeypatch.setattr(kernels, "_fn", lambda lib, name: Fn())
    monkeypatch.setattr(_build, "library", lambda name: Lib())
    with pytest.raises(_build.KernelError, match="peer access"):
        kernels.enable_peers(["cuda:0", "cuda:1"])
    kernels.enable_peers(["cuda:0", "cuda:0"])  # virtual cards of one device need none


# -- the analysis and a shared round over CPU cards -------------------------


@pytest.fixture
def four_cpu_cards(monkeypatch):
    monkeypatch.setattr(backend, "DEVICE", "cpu")
    monkeypatch.setattr(backend, "WARMUP_ASYNC", False)
    monkeypatch.setattr(backend, "DEFAULT_BATCH_CFG", batch.BatchConfig(**MESH_CFG))
    monkeypatch.setattr(backend, "MESH_MODE", "on")
    monkeypatch.setattr(port_solver, "MAX_VARS", 512)
    monkeypatch.setattr(port_solver, "MAX_CLAUSES", 2048)
    monkeypatch.delenv("MYTHRIL_TPU_MESH", raising=False)
    monkeypatch.delenv("MYTHRIL_TPU_FUSED", raising=False)
    port_solver_cache.reset_for_tests()
    yield monkeypatch
    port_solver_cache.reset_for_tests()


def _analyze():
    reset_callback_modules()
    runtime = assemble(RUNTIME).hex()
    n = len(runtime) // 2
    creation = assemble(f"PUSH2 {n}\nPUSH2 :code\nPUSH1 0x00\nCODECOPY\nPUSH2 {n}\nPUSH1 0x00\nRETURN\ncode:").hex()
    sym = SymExecWrapper(EVMContract(code=runtime, creation_code=creation + runtime, name="T"), address=0x1234,
                         strategy="cuda-batch", execution_timeout=480, transaction_count=1, max_depth=64)
    issues = sorted({(i.swc_id, i.address) for i in fire_lasers(sym)})
    return issues, backend.find_tpu_strategy(sym.laser.strategy)


def test_analysis_over_four_cpu_cards(four_cpu_cards):
    """exec_batch with 4 shards over 4 CPU cards reports the SWC set that
    test_torch_mesh_analyze.py gets from the reference and from the
    one-card mesh, [106@19] (the SELFDESTRUCT at 19), from fused mesh rounds
    that ran over the cards."""
    mp = four_cpu_cards
    mp.setattr(mesh, "n_devices", lambda device="cuda": 4)
    seen = []
    run = megakernel.run_fused_mesh
    mp.setattr(megakernel, "run_fused_mesh", lambda m, *a, **k: seen.append(m.cards) or run(m, *a, **k))
    mp.setattr(mesh, "card_devices", lambda n, device="cuda": (torch.device("cpu"),) * n)
    issues, strategy = _analyze()
    assert issues == [("106", 19)]
    assert seen and set(seen) == {4}
    assert strategy.device_rounds > 0 and strategy.degraded_rounds == 0 and strategy.fused_rounds > 0
    assert len(strategy.mesh_occupancy) == 4


def test_two_jobs_one_round_over_two_cards(four_cpu_cards):
    """A shared round of two jobs' lanes (the service's ``job_id`` plane)
    through ``_run_device`` over 2 CPU cards: the batch comes back whole,
    equal to the one-card mesh's round plane for plane, and every lane
    keeps its job."""
    mp = four_cpu_cards
    mp.setattr(mesh, "n_devices", lambda device="cuda": 8)
    mp.setenv("MYTHRIL_TPU_FUSED_K", "4")  # one dispatch of 4 rounds of 8 steps
    mp.setenv("MYTHRIL_TPU_FUSED_STEPS", "8")
    cb, st, _ = _workload("countdown")
    job = torch.tensor([1 if lane % 4 < 2 else 2 for lane in range(16)], dtype=torch.int32)
    st = st._replace(job_id=torch.where(st.alive, job, 0).to(st.job_id.dtype))
    cfg = batch.BatchConfig(**CFG)
    one, _ = backend._run_device(cb, st, cfg)
    mp.setattr(mesh, "card_devices", lambda n, device="cuda": (torch.device("cpu"),) * 2)
    two, _ = backend._run_device(cb, st, cfg)
    assert isinstance(two, batch.StateBatch)
    _assert_batches(two, one, "two jobs over two cards")
    alive = two.alive
    assert set(two.job_id[alive].tolist()) == {1, 2}
    assert set(two.job_id[8:][alive[8:]].tolist()) == {1, 2}  # both jobs' lanes crossed to the second card
    assert int((two.steps * (two.job_id == 1)).sum()) > 0 and int((two.steps * (two.job_id == 2)).sum()) > 0
