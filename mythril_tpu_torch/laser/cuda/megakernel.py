"""The fused super-round: K rounds of step -> prune -> kill -> compact.

Replaces ``mythril_tpu/laser/tpu/megakernel.py`` (single device):
``_fused_impl``, ``_one_round``, ``prune_mask`` and ``compact_impl``.
Each round runs ``steps_per_round`` steps (K1), the in-loop UNSAT screen
(K3) when ``with_solve`` is set, and the round epilogue (K4): REVERT
prune, in-loop kill, counter folds, ``pruned_visited`` union, zeroing of
the dying lanes' counters and a stable compaction that keeps survivors in
order. The loop runs while ``r < max_rounds`` and some lane is RUNNING;
the soundness arguments are the reference's. With ``with_stats`` every
step also folds its retired opcodes into ``hist`` (the reference's
``op_hist_update``, see ``engine``), summed over every step of every
round.

On the card the reference's contract holds: ``run_fused`` queues
``max_rounds x (K1 + K3 + K4)`` launches with no host sync, one K1
launch running the round's ``steps_per_round`` steps (with stats, K1's
stats instance, which also folds the histogram inside the launch), and
the loop condition lives on the device in a control word
``ctl = [r, continue]`` that K4 rewrites after each round. Every kernel
reads it first and returns at once when the loop has ended, which is the
reference's ``while_loop`` condition evaluated between rounds. The only
host read is the caller's fetch of ``info``.

K4 (``csrc/megakernel.cu``) is one cooperative launch. Each thread
plans at most a few lanes (the prune/kill masks and the u32 counter
folds, summed by warp shuffles and one atomic per block); after a grid
barrier every block scans all the lanes' flags in shared memory (K1's
scan) for the stable order, stages the next control word (block 0),
and moves only the rows whose place changes into a scratch batch,
several warps a row, while OR-ing the dying lanes' visited rows into
``pruned_visited``; after a second barrier the moved rows come back
and every dying lane's counters and visited row are zeroed where it now
lies, moved or not; block 0 commits the control word last. The launch
arguments of K3 and K4 (``kernels.UnsatArgs``, ``EpilogueArgs``) are
built once per super-round: the loop updates the batch, the scratch
batch, the mask, the accumulators and the control word in place. Bound
on the H100: bytes — the per-lane flag planes, 2 x the rows that move
and 2 x code_len per dying lane.

``run_fused_mesh`` is the same super-round over a mesh of n lane shards
(the reference's ``_mesh_kernel`` under ``shard_map``, B12): K1 places
forks and K4 compacts inside each shard's lane block, and between rounds
one launch of the steal kernel (K10/K11, ``mesh.steal_round``) plans the
work-steal and moves the lanes, gated on the device; ``info`` grows to
i32[9 + n].
"""

from typing import NamedTuple

import torch

from mythril_tpu_torch import obs
from mythril_tpu_torch.laser.cuda import _build, engine, inloop_solve
from mythril_tpu_torch.laser.cuda.batch import REVERTED, RUNNING, TRAP, CodeBank, Env, StateBatch

REVERT_OP = 0xFD

launches = 0  # K4 launches (CUDA path only)


class FusedOut(NamedTuple):
    st: StateBatch
    # i32[7]: [rounds_done, pruned_lanes, pruned_steps, pruned_static,
    #          n_alive, n_running, inloop_kills]
    info: torch.Tensor
    pruned_visited: torch.Tensor  # bool[n_codes, code_len]
    hist: torch.Tensor  # u32[256] retired-opcode histogram (with_stats) or u32[1] zeros, as int32 bits


class FusedStats(NamedTuple):
    rounds: int
    pruned_lanes: int
    pruned_steps: int
    pruned_static: int
    n_alive: int
    n_running: int
    inloop_kills: int


def prune_mask(cb: CodeBank, st: StateBatch) -> torch.Tensor:
    at_revert = (st.status == REVERTED) | ((st.status == TRAP) & (st.trap_op == REVERT_OP))
    return st.alive & st.outermost & cb.prune_revert & at_revert


def compact_plain(s: StateBatch, n_shards: int = 1) -> StateBatch:
    """Twin of ``compact_impl`` (megakernel.py:121): a stable sort on the
    dead flag, inside each of ``n_shards`` contiguous lane blocks (the
    fused mesh tier compacts per shard under shard_map)."""
    L = s.pc.shape[0]
    per = L // n_shards
    order = torch.argsort(s.alive.to(torch.int32).view(n_shards, per), dim=1, descending=True, stable=True)
    order = (order + torch.arange(0, L, per, device=order.device)[:, None]).reshape(L)
    return StateBatch(*(x[order] for x in s))


def round_epilogue_plain(cb: CodeBank, s: StateBatch, unsat, acc, pv, n_shards: int = 1):
    """Twin of the reference's per-round tail (megakernel.py:174-196).

    ``unsat`` is bool[L] (all False without the in-loop screen), ``acc``
    int32[4] = [pruned_lanes, pruned_steps, pruned_static, inloop_kills]
    and ``pv`` the pruned_visited plane; both are updated in place.
    Returns the compacted batch (compacted per lane block with
    ``n_shards`` > 1)."""
    dead = prune_mask(cb, s)
    killed = unsat & ~dead
    dying = dead | killed
    acc[0] += dead.to(torch.int32).sum().to(torch.int32)
    acc[3] += killed.to(torch.int32).sum().to(torch.int32)
    acc[1] += torch.where(dying, s.steps, 0).sum().to(torch.int32)
    acc[2] += torch.where(dying, s.static_pruned, 0).sum().to(torch.int32)
    for cid in torch.unique(s.code_id[dying]).tolist():
        rows = dying & (s.code_id == cid)
        pv[cid] |= s.visited[rows].any(0)
    s = s._replace(
        alive=s.alive & ~dying,
        steps=torch.where(dying, 0, s.steps),
        static_pruned=torch.where(dying, 0, s.static_pruned),
        visited=torch.where(dying[:, None], False, s.visited),
    )
    return compact_plain(s, n_shards)


def _any_running(s: StateBatch):
    return (s.alive & (s.status == RUNNING)).any()


def _info(r, acc, out: StateBatch):
    n_alive = out.alive.to(torch.int32).sum().to(torch.int32)
    n_running = (out.alive & (out.status == RUNNING)).to(torch.int32).sum().to(torch.int32)
    return torch.stack([r.to(torch.int32), acc[0], acc[1], acc[2], n_alive, n_running, acc[3]])


def run_fused(
    cb: CodeBank,
    env: Env,
    st: StateBatch,
    max_rounds: int,
    steps_per_round: int = 512,
    with_stats: bool = False,
    with_solve: bool = False,
    pool=None,
    device="cuda",
) -> FusedOut:
    """One fused super-round: up to ``max_rounds`` rounds without a host
    sync on the card. The caller owns the one fetch of ``out.info``."""
    dev = _build.check_on(device, st.pc, cb.code)
    if pool is None:
        pool = inloop_solve.empty_pool(dev)
    L = st.pc.shape[0]
    n_codes, W = cb.code.shape
    pv = torch.zeros((n_codes, W), dtype=torch.bool, device=dev)
    acc = torch.zeros(4, dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        return run_fused_plain(cb, st, max_rounds, steps_per_round, with_solve, pool, with_stats)

    # card: everything queued, the loop condition on the device
    from mythril_tpu_torch.laser.cuda import kernels

    with obs.TRACER.span("fused.setup", tid="device"):
        s = StateBatch(*(x.clone() for x in st))
        ctl = torch.zeros(4, dtype=torch.int32, device=dev)  # [r, continue, staged r, staged continue]
        ctl[1] = (_any_running(s) & (max_rounds > 0)).to(torch.int32)
        scratch = StateBatch(*(torch.empty_like(x) for x in s))
        unsat = torch.zeros(L, dtype=torch.bool, device=dev)
        args = kernels.StepArgs(cb, s)
        k3 = kernels.UnsatArgs(pool, s, ctl, unsat) if with_solve else None
        k4 = kernels.EpilogueArgs(cb, s, unsat, acc, pv, ctl, int(max_rounds), scratch)
        hist = torch.zeros(256 if with_stats else 1, dtype=torch.int32, device=dev)
    with obs.TRACER.span("fused.enqueue", tid="device"):
        for _ in range(int(max_rounds)):  # the round's steps in one K1 launch
            engine.step_n(cb, env, s, steps_per_round, device=dev, ctl=ctl, inplace=True, args=args,
                          hist=hist if with_stats else None)
            if with_solve:
                inloop_solve.unsat_mask(pool, s, device=dev, ctl=ctl, out=unsat, args=k3)
            round_epilogue(cb, s, unsat, acc, pv, ctl, max_rounds, scratch, args=k4)
    return FusedOut(s, _info(ctl[0], acc, s), pv, hist)


def run_fused_plain(cb, st, max_rounds, steps_per_round, with_solve, pool, with_stats=False) -> FusedOut:
    """The twin of the whole super-round, on any device (it syncs to
    evaluate the loop condition on the host)."""
    dev = st.pc.device
    L = st.pc.shape[0]
    pv = torch.zeros(cb.code.shape, dtype=torch.bool, device=dev)
    acc = torch.zeros(4, dtype=torch.int32, device=dev)
    hist = torch.zeros(256 if with_stats else 1, dtype=torch.int32, device=dev)
    r = 0
    s = st
    while r < max_rounds and bool(_any_running(s)):
        for _ in range(steps_per_round):
            ns = engine.step_plain(cb, s)
            if with_stats:
                hist = engine.op_hist_update_plain(cb, s, ns, hist)
            s = ns
        if with_solve:
            unsat = inloop_solve.unsat_mask_plain(pool, s)
        else:
            unsat = torch.zeros(L, dtype=torch.bool, device=dev)
        s = round_epilogue_plain(cb, s, unsat, acc, pv)
        r += 1
    return FusedOut(s, _info(torch.tensor(r, device=dev), acc, s), pv, hist)


def round_epilogue(cb, s, unsat, acc, pv, ctl, max_rounds, scratch, n_shards=1, flags=None, gate=None, args=None):
    """K4 on the card: prune/kill/fold/compact ``s`` in place, advance
    ``ctl``. ``unsat`` must be all False when the screen is off. The
    fused mesh loop passes ``n_shards``, defers the commit of ``ctl``
    (``flags``) and runs a bare compaction gated on its steal word.
    ``args`` is a ``kernels.EpilogueArgs`` a loop built once for these
    arguments."""
    from mythril_tpu_torch.laser.cuda import kernels

    global launches
    launches += 1
    flags = kernels.EPI_COMMIT if flags is None else flags
    kernels.launch_epilogue(cb, s, unsat, acc, pv, ctl, int(max_rounds), scratch, n_shards, flags, gate, args)


def decode_info(info) -> FusedStats:
    """ONE blocking device->host fetch for all fused-round scalars."""
    with _build.sync_point():
        vals = info.detach().cpu().tolist()
    return FusedStats(*(int(v) for v in vals))


# -- the fused MESH super-round (B12) -------------------------------------


class MeshFusedStats(NamedTuple):
    """Host-side decode of the fused-mesh info vector (i32[9 + n]: eight
    scalars, the per-shard occupancy, then the in-loop kill count)."""

    rounds: int
    pruned_lanes: int
    pruned_steps: int
    pruned_static: int
    n_alive: int
    n_running: int
    steal_events: int
    steal_lanes: int
    occupancy: tuple  # per-shard running lanes at loop exit
    inloop_kills: int


def decode_mesh_info(info, n_shards: int) -> MeshFusedStats:
    """ONE blocking device->host fetch for all fused-mesh scalars."""
    with _build.sync_point():
        vals = [int(v) for v in info.detach().cpu().tolist()]
    return MeshFusedStats(*vals[:8], tuple(vals[8:8 + n_shards]), vals[8 + n_shards])


def _fold_cards(xs, d0, op):
    out = xs[0]
    for x in xs[1:]:
        out = op(out, x.to(d0))
    return out


def _mesh_info(r, acc, sev, sln, out, n: int):
    """The fused mesh info vector of ``out``, a batch or its per-card
    split (then on the first card)."""
    parts = out if isinstance(out, (list, tuple)) and not isinstance(out, StateBatch) else [out]
    d0 = parts[0].pc.device
    nl = n // len(parts)
    occs = [(p.alive & (p.status == RUNNING)).to(torch.int32).view(nl, -1).sum(1).to(torch.int32).to(d0)
            for p in parts]
    occ = occs[0] if len(occs) == 1 else torch.cat(occs)
    n_alive = _fold_cards([p.alive.to(torch.int32).sum().to(torch.int32) for p in parts], d0, torch.add)
    head = torch.stack([r.to(torch.int32), acc[0], acc[1], acc[2], n_alive, occ.sum().to(torch.int32),
                        sev.to(torch.int32), sln.to(torch.int32)])
    return torch.cat([head, occ, acc[3:4]])


def run_fused_mesh(
    mesh,
    cb: CodeBank,
    env: Env,
    st: StateBatch,
    max_rounds: int,
    steps_per_round: int = 512,
    with_stats: bool = False,
    with_solve: bool = False,
    pool=None,
) -> FusedOut:
    """One fused MESH super-round over ``mesh`` (``mesh.n`` lane blocks of
    ``st`` on ``mesh.device``), as the reference's ``_mesh_kernel`` runs
    it under ``shard_map`` (megakernel.py:360-449): each round steps with
    forks placed per shard (K1), screens (K3) and prunes, kills and
    compacts per shard (K4); then the work-steal, one launch of the steal
    kernel: it plans from the per-shard counts, decides ``moved > 0 and
    spread > 1`` into a control word and moves the lanes when it says so;
    a bare per-shard compaction (K4) follows, gated on that word. The loop runs while
    ``r < max_rounds`` and some lane of any shard runs. ``info`` is
    i32[9 + n] (``decode_mesh_info``); ``hist`` sums over the shards and
    ``pruned_visited`` ORs over them, as the reference's psums do.

    Over several cards (``mesh.cards`` > 1) ``st`` is the whole batch or
    its ``mesh.PerCard`` split (``mesh.shard_batch``), and ``out.st`` the
    split: each card runs K1, K3 and K4 over its own n / cards shards and
    the steal is the cross-card exchange (``_run_fused_mesh_cards``);
    ``info``, ``pruned_visited`` and ``hist`` lie on the first card and
    equal the one-card layout's for the same n shards.

    On the card ``max_rounds x (K1 + K3 + K4 + steal + K4)`` launches
    are queued with no host sync (with stats, K1's stats instance folds
    the histogram inside its launch); the round's control word is
    committed after the steal and its compaction, which run under it
    (the reference's body is round + steal). The caller fetches ``info``
    once."""
    n = mesh.n
    if mesh.cards > 1:
        return _run_fused_mesh_cards(mesh, cb, env, st, max_rounds, steps_per_round, with_stats, with_solve, pool)
    L = st.pc.shape[0]
    if L % n != 0:
        raise ValueError(f"lane count {L} not divisible by mesh size {n}")
    dev = _build.check_on(mesh.device, st.pc, cb.code)
    if pool is None:
        pool = inloop_solve.empty_pool(dev)
    if dev.type == "cpu":
        return run_fused_mesh_plain(cb, st, n, max_rounds, steps_per_round, with_solve, pool, with_stats)
    from mythril_tpu_torch.laser.cuda import kernels, mesh as mesh_lib

    s = StateBatch(*(x.clone() for x in st))
    pv = torch.zeros(cb.code.shape, dtype=torch.bool, device=dev)
    acc = torch.zeros(4, dtype=torch.int32, device=dev)
    ctl = torch.zeros(4, dtype=torch.int32, device=dev)
    ctl[1] = (_any_running(s) & (max_rounds > 0)).to(torch.int32)
    scratch = StateBatch(*(torch.empty_like(x) for x in s))
    unsat = torch.zeros(L, dtype=torch.bool, device=dev)
    args = kernels.StepArgs(cb, s, n)
    margs = kernels.MeshArgs(s, n, ctl)
    k3 = kernels.UnsatArgs(pool, s, ctl, unsat) if with_solve else None
    k4 = kernels.EpilogueArgs(cb, s, unsat, acc, pv, ctl, int(max_rounds), scratch, n)
    hist = torch.zeros(256 if with_stats else 1, dtype=torch.int32, device=dev)
    for _ in range(int(max_rounds)):
        engine.step_n(cb, env, s, steps_per_round, device=dev, ctl=ctl, inplace=True, args=args, n_shards=n,
                      hist=hist if with_stats else None)
        if with_solve:
            inloop_solve.unsat_mask(pool, s, device=dev, ctl=ctl, out=unsat, args=k3)
        round_epilogue(cb, s, unsat, acc, pv, ctl, max_rounds, scratch, n, flags=0, args=k4)
        mesh_lib.steal_round(margs)
        round_epilogue(cb, s, unsat, acc, pv, ctl, max_rounds, scratch, n,
                       flags=kernels.EPI_COMMIT | kernels.EPI_COMPACT_ONLY, gate=margs.mctl, args=k4)
    info = _mesh_info(ctl[0], acc, margs.mctl[2], margs.mctl[3], s, n)
    return FusedOut(s, info, pv, hist)


def run_fused_mesh_plain(cb, st, n_shards, max_rounds, steps_per_round, with_solve, pool,
                         with_stats=False) -> FusedOut:
    """The twin of the whole fused mesh super-round, on any device (it
    syncs to evaluate the loop condition and the steal gate on the
    host)."""
    from mythril_tpu_torch.laser.cuda import mesh as mesh_lib

    dev = st.pc.device
    L = st.pc.shape[0]
    n = n_shards
    pv = torch.zeros(cb.code.shape, dtype=torch.bool, device=dev)
    acc = torch.zeros(4, dtype=torch.int32, device=dev)
    hist = torch.zeros(256 if with_stats else 1, dtype=torch.int32, device=dev)
    r = sev = sln = 0
    s = st
    while r < max_rounds and bool(_any_running(s)):
        for _ in range(steps_per_round):
            ns = engine.step_plain(cb, s, n)
            if with_stats:
                hist = engine.op_hist_update_plain(cb, s, ns, hist)
            s = ns
        if with_solve:
            unsat = inloop_solve.unsat_mask_plain(pool, s)
        else:
            unsat = torch.zeros(L, dtype=torch.bool, device=dev)
        s = round_epilogue_plain(cb, s, unsat, acc, pv, n)
        plan = mesh_lib.steal_plan_plain(s, n)
        moved = int(plan.moved)
        if moved > 0 and int(plan.occ.max()) - int(plan.occ.min()) > 1:
            s = compact_plain(mesh_lib.steal_apply_plain(s, plan, n), n)
            sev += 1
            sln += moved
        r += 1
    t = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    return FusedOut(s, _mesh_info(t(r), acc, t(sev), t(sln), s, n), pv, hist)


# -- the fused mesh super-round over several cards ---------------------


def _run_fused_mesh_cards(mesh, cb, env, st, max_rounds, steps_per_round, with_stats, with_solve, pool):
    """``run_fused_mesh`` over ``mesh.cards`` cards. Each round, on each
    card under its device and on its stream: K1 over the card's
    ``nl = n / cards`` shards (forks placed per shard, as under
    shard_map), K3, K4 staging the next control word; then the
    cross-card exchange (``mesh.CardExchange``: the counts gathered into
    every card, the same plan on every card with the continue bit
    restaged from the mesh-wide running total, the moves in place and
    into the send batches, the pulls); then each card's compaction
    gated on its steal word, committing its control word. Every card's
    control word takes the same values, so the cards run the same
    rounds. The host fetches nothing: the caller fetches ``info`` once.
    On CPU cards the twins run the same steps (``run_fused_mesh_cards_plain``)."""
    from mythril_tpu_torch.laser.cuda import kernels, mesh as mesh_lib

    n, cards, max_rounds = mesh.n, mesh.cards, int(max_rounds)
    nl = n // cards
    parts = mesh_lib.shard_batch(st, mesh)
    cbs = mesh_lib.put_replicated(cb, mesh)
    envs = mesh_lib.put_replicated(env, mesh) if env is not None else [None] * cards
    devs = [_build.check_on(d, p.pc, c.code) for d, p, c in zip(mesh.devices, parts, cbs)]
    if pool is None:
        pool = inloop_solve.empty_pool(devs[0])
    pools = mesh_lib.put_replicated(pool, mesh)
    if devs[0].type == "cpu":
        return run_fused_mesh_cards_plain(cbs, parts, n, max_rounds, steps_per_round, with_solve, pools, with_stats)
    cs = []
    for k, d in enumerate(devs):
        with torch.cuda.device(d):
            s = StateBatch(*(x.clone() for x in parts[k]))
            L = s.pc.shape[0]
            c = dict(s=s, cb=cbs[k], env=envs[k], pool=pools[k], dev=d,
                     pv=torch.zeros(cbs[k].code.shape, dtype=torch.bool, device=d),
                     acc=torch.zeros(4, dtype=torch.int32, device=d),
                     ctl=torch.zeros(4, dtype=torch.int32, device=d),
                     unsat=torch.zeros(L, dtype=torch.bool, device=d),
                     hist=torch.zeros(256 if with_stats else 1, dtype=torch.int32, device=d),
                     scratch=StateBatch(*(torch.empty_like(x) for x in s)))
            c["args"] = kernels.StepArgs(cbs[k], s, nl)
            c["k3"] = kernels.UnsatArgs(pools[k], s, c["ctl"], c["unsat"]) if with_solve else None
            c["k4"] = kernels.EpilogueArgs(cbs[k], s, c["unsat"], c["acc"], c["pv"], c["ctl"], max_rounds,
                                           c["scratch"], nl)
            cs.append(c)
    ex = mesh_lib.CardExchange([c["s"] for c in cs], n, [c["ctl"] for c in cs], max_rounds)
    ex.start()
    for _ in range(max_rounds):
        for c in cs:
            with torch.cuda.device(c["dev"]):
                engine.step_n(c["cb"], c["env"], c["s"], steps_per_round, device=c["dev"], ctl=c["ctl"], inplace=True,
                              args=c["args"], n_shards=nl, hist=c["hist"] if with_stats else None)
                if with_solve:
                    inloop_solve.unsat_mask(c["pool"], c["s"], device=c["dev"], ctl=c["ctl"], out=c["unsat"],
                                            args=c["k3"])
                round_epilogue(c["cb"], c["s"], c["unsat"], c["acc"], c["pv"], c["ctl"], max_rounds, c["scratch"], nl,
                               flags=0, args=c["k4"])
        ex.steal_round()
        for c, mctl in zip(cs, ex.mctls):
            with torch.cuda.device(c["dev"]):
                round_epilogue(c["cb"], c["s"], c["unsat"], c["acc"], c["pv"], c["ctl"], max_rounds, c["scratch"], nl,
                               flags=kernels.EPI_COMMIT | kernels.EPI_COMPACT_ONLY, gate=mctl, args=c["k4"])
    d0 = devs[0]
    parts = mesh_lib.PerCard(c["s"] for c in cs)
    with torch.cuda.device(d0):
        acc = _fold_cards([c["acc"] for c in cs], d0, torch.add)
        info = _mesh_info(cs[0]["ctl"][0], acc, ex.mctls[0][2], ex.mctls[0][3], parts, n)
        pv = _fold_cards([c["pv"] for c in cs], d0, torch.logical_or)
        hist = _fold_cards([c["hist"] for c in cs], d0, torch.add)
    return FusedOut(parts, info, pv, hist)


def run_fused_mesh_cards_plain(cbs, parts, n_shards, max_rounds, steps_per_round, with_solve, pools,
                               with_stats=False) -> FusedOut:
    """The twin of the cross-card super-round: each card's round over its
    own shards, then the exchange's twins (``mesh.exchange_plain``) and,
    when it stole, each card's compaction. It syncs to evaluate the loop
    condition on the host. Equal to ``run_fused_mesh_plain`` on the
    joined batch, plane for plane."""
    from mythril_tpu_torch.laser.cuda import mesh as mesh_lib

    cards = len(parts)
    nl = n_shards // cards
    d0 = parts[0].pc.device
    accs = [torch.zeros(4, dtype=torch.int32, device=p.pc.device) for p in parts]
    pvs = [torch.zeros(cb.code.shape, dtype=torch.bool, device=cb.code.device) for cb in cbs]
    hists = [torch.zeros(256 if with_stats else 1, dtype=torch.int32, device=p.pc.device) for p in parts]
    r = sev = sln = 0
    parts = list(parts)
    while r < max_rounds and any(bool(_any_running(p)) for p in parts):
        for k, (cb, pool) in enumerate(zip(cbs, pools)):
            s = parts[k]
            for _ in range(steps_per_round):
                ns = engine.step_plain(cb, s, nl)
                if with_stats:
                    hists[k] = engine.op_hist_update_plain(cb, s, ns, hists[k])
                s = ns
            unsat = (inloop_solve.unsat_mask_plain(pool, s) if with_solve
                     else torch.zeros(s.pc.shape[0], dtype=torch.bool, device=s.pc.device))
            parts[k] = round_epilogue_plain(cb, s, unsat, accs[k], pvs[k], nl)
        parts, go, moved = mesh_lib.exchange_plain(parts, n_shards)
        parts = list(parts)
        if go:
            parts = [compact_plain(p, nl) for p in parts]
            sev += 1
            sln += moved
        r += 1
    t = lambda v: torch.tensor(v, dtype=torch.int32, device=d0)  # noqa: E731
    acc = _fold_cards(accs, d0, torch.add)
    info = _mesh_info(t(r), acc, t(sev), t(sln), parts, n_shards)
    return FusedOut(mesh_lib.PerCard(parts), info, _fold_cards(pvs, d0, torch.logical_or),
                    _fold_cards(hists, d0, torch.add))
