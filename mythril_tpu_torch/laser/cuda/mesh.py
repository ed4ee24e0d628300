"""The mesh tiers: n lane shards over one or more cards, the work-steal
and the deal.

Replaces ``mythril_tpu/laser/tpu/mesh.py``. The reference shards the
lane axis of the ``StateBatch`` over a ``jax.sharding.Mesh`` of devices
(``PartitionSpec('paths')``) and runs it in two tiers:

- the fused mesh tier (``megakernel.run_fused_mesh``): the super-round
  under ``shard_map``, each shard stepping, pruning and compacting its
  own block, with a work-steal between rounds (``steal_plan`` +
  ``steal_apply``: one all_gather of the per-shard [running, alive]
  counts, then one all_to_all per plane);
- the sync mesh tier (``round_impl``/``sharded_round``): a GSPMD round
  over all lanes, then ``rebalance`` (a stable partition of the running
  lanes dealt round-robin over the shards, an all-to-all) and
  ``occupancy_impl`` (running lanes per shard).

Here a mesh of n shards spans ``cards`` torch devices (``Mesh.devices``),
each card holding n / cards contiguous shards of ``per = L / n`` lanes
as a batch of its own; a card may repeat another's device (virtual
cards of one device, as the reference's tests run n virtual devices of
one host). With one card the shards are n contiguous blocks of one
batch, and what crossed devices is two CUDA kernels (``csrc/mesh.cu``):

- the steal kernel (K10 and K11, one cooperative launch a use): the
  per-shard counts and the steal plan (K10's function: a thread a lane,
  warp ballots and scans, no serial walk) and the lane moves (K11's:
  every exported lane's row of every plane copied into its receiver slot
  by the whole grid in 16-byte units, the exporter killed with its
  ``steps``/``static_pruned``/``visited`` zeroed). The fused loop's
  ``steal_round`` does both in one launch, with the steal decision
  ``moved > 0 and max(occ) - min(occ) > 1`` taken on the card;
  ``occupancy_impl``, ``steal_plan`` and ``steal_apply`` launch it for
  one function each;
- K12 ``mesh_deal`` (one cooperative launch a deal: every block orders
  the deal from the running bits, a thread a lane, and the grid moves
  only the rows whose slot changes, through a scratch batch kept per
  batch shape): ``rebalance`` and the sync mesh round.

With several cards the fused loop's steal is the cross-card exchange
(``CardExchange``: the same kernel file's ``mesh_cards_kernel`` in three
modes, one launch each on every card, ordered across cards by events):
each card stores its shards' counts into every card's gathered buffer
(XC_COUNT, the all_gather); every card plans from them alike, moves its
exporters bound for its own shards in place and packs those bound for
other cards into its send batch (XC_PLAN); each card then copies its
imports out of the donors' send batches through peer pointers (XC_PULL,
the all_to_all's rows, and only the planned ones). The sync mesh tier
places forks over all lanes, as GSPMD does, so it runs on the first card
with the whole batch. Each kernel has a plain twin (``*_plain``), which
the wrappers run on CPU tensors.
"""

from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from mythril_tpu_torch.laser.cuda import _build, engine
from mythril_tpu_torch.laser.cuda.batch import RUNNING, StateBatch

I32 = torch.int32

launches = 0  # launches of the steal kernel, whatever their use (CUDA path only)
plan_launches = 0  # of those, the ones that counted or planned (K10's function)
steal_launches = 0  # of those, the ones that moved lanes or decided whether to (K11's function)
deal_launches = 0  # K12 launches (CUDA path only)
# launches of the cross-card exchange, by mode (CUDA path only)
xc_count_launches = 0
xc_plan_launches = 0
xc_pull_launches = 0


class Mesh(NamedTuple):
    """n lane shards over ``devices``, the cards (a card may repeat
    another's device), n / cards contiguous shards a card; ``device`` is
    the first card's. One card is the mesh of n blocks of one batch."""

    n: int
    device: torch.device
    devices: tuple = ()

    @property
    def cards(self) -> int:
        return max(1, len(self.devices))


class PerCard(tuple):
    """One object per card of a mesh, in card order: the parts of a split
    batch (``shard_batch``) or the copies of a replicated tree
    (``put_replicated``)."""


def _peer_cards() -> int:
    """The host's cards a mesh may span: the first k of them (k at
    least 1) of which each can reach every other's memory
    (``cudaDeviceCanAccessPeer``). Cards behind separate root complexes,
    or in a VM that hides peer access, leave the mesh on the first card
    rather than failing where the exchange enables peer access."""
    count, k = torch.cuda.device_count(), 1
    while k < count and all(torch.cuda.can_device_access_peer(k, j) and torch.cuda.can_device_access_peer(j, k)
                            for j in range(k)):
        k += 1
    return k


def n_devices(device="cuda") -> int:
    """The counterpart of the reference's ``len(jax.devices())``: the
    shards a mesh spans by default, one a card. On "cuda" the host's
    cards that reach each other (``_peer_cards``); on the CPU 1, so the
    backend stays on the single-device tiers there. The tests and
    ``chip_smoke.py`` patch it to put n shards on one card, as the
    reference's tests force 8 virtual devices."""
    if torch.device(device).type != "cuda":
        return 1
    return _peer_cards()


def card_devices(n: int, device="cuda") -> tuple:
    """The cards a mesh of ``n`` shards spans unless told: on "cuda" the
    host's first k cards that reach each other, k the most of them (at
    most MESH_MAX_CARDS) that divides n; one card (``device`` as given)
    where that is 1, and on the CPU."""
    from mythril_tpu_torch.laser.cuda.kernels import MESH_MAX_CARDS

    dev = torch.device(device)
    count = min(_peer_cards(), MESH_MAX_CARDS) if dev.type == "cuda" else 1
    k = max(d for d in range(1, max(1, min(count, n)) + 1) if n % d == 0)
    return (dev,) if k == 1 else tuple(torch.device("cuda", i) for i in range(k))


@lru_cache(maxsize=None)
def _mesh_cached(n: int, devices: tuple) -> Mesh:
    from mythril_tpu_torch.laser.cuda import kernels

    if n < 1 or n % len(devices) or len(devices) > kernels.MESH_MAX_CARDS:
        raise ValueError(f"{n} shards do not split over {len(devices)} cards (at most {kernels.MESH_MAX_CARDS})")
    if len({d for d in devices if d.type == "cuda"}) > 1:
        kernels.enable_peers(devices)
    return Mesh(n, devices[0], devices)


def make_mesh(n_devices_: Optional[int] = None, device="cuda", cards=None) -> Mesh:
    """The mesh of ``n_devices_`` shards (default: ``n_devices()``) over
    ``cards`` (torch devices; default ``card_devices``, which counts only
    cards that reach each other), cached per size and cards as the
    reference caches its Mesh. Distinct CUDA cards get peer access to
    each other here, or this raises: an explicit ``cards`` list that
    names a pair without peer access is an error, never a fallback."""
    n = int(n_devices(device) if n_devices_ is None else n_devices_)
    devs = card_devices(n, device) if cards is None else tuple(torch.device(d) for d in cards)
    return _mesh_cached(n, devs)


def shard_batch(st, mesh: Mesh):
    """The batch on the mesh: with one card the batch on its device (its
    lane blocks are the shards); with several a ``PerCard`` of each
    card's contiguous lanes on its device."""
    if mesh.cards == 1:
        return StateBatch(*(x.to(mesh.device) for x in gather_batch(st, mesh)))
    if isinstance(st, PerCard) and len(st) == mesh.cards:
        return st
    L = st.pc.shape[0]
    if L % mesh.n:
        raise ValueError(f"lane count {L} not divisible by mesh size {mesh.n}")
    lc = L // mesh.cards
    return PerCard(StateBatch(*(x[k * lc:(k + 1) * lc].to(d) for x in st)) for k, d in enumerate(mesh.devices))


def gather_batch(st, mesh: Optional[Mesh] = None) -> StateBatch:
    """A split batch joined back into one ``StateBatch`` on the first
    card (``mesh.device``, else the first part's); a ``StateBatch`` comes
    back as it is."""
    if not isinstance(st, PerCard):
        return st
    d0 = mesh.device if mesh is not None else st[0].pc.device
    return StateBatch(*(torch.cat([x.to(d0) for x in planes]) for planes in zip(*st)))


def _put(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        items = [_put(x, device) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def put_replicated(tree, mesh: Mesh):
    """A tuple or NamedTuple of tensors (code bank, env, pool) on the
    mesh: on its device with one card, else a ``PerCard`` of copies, one
    on each card."""
    if isinstance(tree, PerCard):
        return tree
    if mesh.cards == 1:
        return _put(tree, mesh.device)
    return PerCard(_put(tree, d) for d in mesh.devices)


def _running(st: StateBatch) -> torch.Tensor:
    return st.alive & (st.status == RUNNING)


def _clone(st: StateBatch) -> StateBatch:
    return StateBatch(*(x.clone() for x in st))


# -- host policy --------------------------------------------------------


def occupancy(st: StateBatch, n_shards: int) -> np.ndarray:
    """Per-shard running-lane counts (host-side rebalance gating)."""
    with _build.sync_point():
        running = _running(st).cpu().numpy()
    if running.shape[0] % n_shards != 0:
        raise ValueError(
            f"lane count {running.shape[0]} not divisible by n_shards {n_shards}"
        )
    return running.reshape(n_shards, -1).sum(axis=1)


def should_rebalance(st: StateBatch, n_shards: int) -> bool:
    """Only permute when shard occupancy diverges: a perfect deal leaves
    max-min <= 1, so fire only when the spread is worse than that. Reads
    the alive plane (one sync); the round loop uses
    :func:`should_rebalance_occ` on the vector it already fetched."""
    L = st.pc.shape[0]
    if n_shards < 2 or L % n_shards != 0:
        return False
    occ = occupancy(st, n_shards)
    if occ.sum() == 0:
        return False
    return int(occ.max()) - int(occ.min()) > 1


def should_rebalance_occ(occ) -> bool:
    """should_rebalance() on an already-fetched occupancy vector."""
    occ = np.asarray(occ)
    if occ.shape[0] < 2 or occ.sum() == 0:
        return False
    return int(occ.max()) - int(occ.min()) > 1


# -- K12: rebalance -----------------------------------------------------


def deal_order_plain(st: StateBatch, n_shards: int) -> torch.Tensor:
    """The deal's lane order: running lanes first (stable), then slot
    ``s * per + k`` takes packed lane ``k * n + s``."""
    L = st.pc.shape[0]
    per = L // n_shards
    order = torch.argsort((~_running(st)).to(I32), stable=True)
    deal = torch.arange(L, device=order.device).reshape(per, n_shards).T.reshape(-1)
    return order[deal]


def rebalance_plain(st: StateBatch, n_shards: int = 1) -> StateBatch:
    """Twin of K12 (mesh.py:83 ``rebalance``)."""
    L = st.pc.shape[0]
    if n_shards < 2 or L % n_shards != 0:
        return st
    order = deal_order_plain(st, n_shards)
    return StateBatch(*(x[order] for x in st))


def deal_(st: StateBatch, n_shards: int, device="cuda") -> StateBatch:
    """The deal of a batch its caller owns: on the card K12 deals ``st``
    in place and returns it; on the CPU the twin returns a dealt copy.
    ``n_shards`` >= 2 must divide the lanes."""
    dev = _build.check_on(device, st.pc)
    if dev.type == "cpu":
        return rebalance_plain(st, n_shards)
    from mythril_tpu_torch.laser.cuda import kernels

    global deal_launches
    deal_launches += 1
    kernels.launch_mesh_deal(st, n_shards)
    return st


def rebalance(st: StateBatch, n_shards: int = 1, device="cuda") -> StateBatch:
    """Deal the running lanes evenly over the shards; a no-op with fewer
    than 2 shards or a lane count they do not divide (packing without
    dealing would pile the work onto shard 0). Pure, as the reference's:
    on the card one clone of ``st``, then K12 deals the clone in place."""
    dev = _build.check_on(device, st.pc)
    L = st.pc.shape[0]
    if n_shards < 2 or L % n_shards != 0:
        return st
    return deal_(st if dev.type == "cpu" else _clone(st), n_shards, device=dev)


# -- the steal kernel: occupancy, the steal plan, the moves ------------


class StealPlan(NamedTuple):
    """The work-steal schedule of the whole mesh (the reference builds it
    per shard inside shard_map; here the per-lane fields are the shards'
    blocks side by side)."""

    export: torch.Tensor  # bool[L]  lanes their shard donates
    buf_pos: torch.Tensor  # i32[L]  dest * per + slot, n * per when not exported
    filled: torch.Tensor  # i32[n]  lanes each shard imports
    occ: torch.Tensor  # i32[n]  running lanes per shard (pre-steal)
    alive_c: torch.Tensor  # i32[n]  alive lanes per shard (pre-steal)
    moved: torch.Tensor  # i32[]  lanes moved mesh-wide


def occupancy_impl_plain(st: StateBatch, n_shards: int) -> torch.Tensor:
    """Twin of K10's counts (mesh.py:237 ``occupancy_impl``)."""
    return _running(st).to(I32).reshape(n_shards, -1).sum(1).to(I32)


def _launch(a, flags: int) -> None:
    """One launch of the steal kernel, counted by the functions it does."""
    from mythril_tpu_torch.laser.cuda import kernels

    global launches, plan_launches, steal_launches
    launches += 1
    if flags & kernels.MESH_PLAN or not flags & kernels.MESH_MOVE:
        plan_launches += 1
    if flags & kernels.MESH_MOVE:
        steal_launches += 1
    kernels.launch_mesh_steal(a, flags)


def occupancy_impl(st: StateBatch, n_shards: int, device="cuda") -> torch.Tensor:
    """Running lanes per shard, i32[n_shards], computed on the device
    (the steal kernel counting only, on the card)."""
    dev = _build.check_on(device, st.pc)
    if st.pc.shape[0] % n_shards != 0:
        raise ValueError(f"lane count {st.pc.shape[0]} not divisible by n_shards {n_shards}")
    if dev.type == "cpu":
        return occupancy_impl_plain(st, n_shards)
    from mythril_tpu_torch.laser.cuda import kernels

    a = kernels.MeshArgs(st, n_shards)
    _launch(a, 0)
    return a.sh[:n_shards]


def _plan_scalars(occ, alive_c, per: int):
    """The steal plan's shard scalars (mesh.py:150-166) from the per-shard
    running and alive counts (int64[n]): the fair-share target, surplus,
    deficit capped by free lanes, the lanes moved and the exclusive
    cumsums. Returns (surplus, deficit, moved, donor_base, recv_base,
    recv_end)."""
    n = occ.shape[0]
    total = occ.sum()
    base = total // n
    rem = total - base * n
    target = base + (torch.arange(n, device=occ.device) < rem).to(occ.dtype)
    surplus = torch.clamp(occ - target, min=0)
    deficit = torch.minimum(torch.clamp(target - occ, min=0), per - alive_c)
    moved = torch.minimum(surplus.sum(), deficit.sum())
    recv_end = torch.cumsum(deficit, 0)
    return surplus, deficit, moved, torch.cumsum(surplus, 0) - surplus, recv_end - deficit, recv_end


def steal_plan_plain(st: StateBatch, n_shards: int) -> StealPlan:
    """Twin of K10's plan (mesh.py:127 ``steal_plan``), every shard's
    plan at once: the fair-share target, surplus and deficit (capped by
    free lanes), the exclusive cumsums and the searchsorted of each
    exported global donor index into ``recv_end``."""
    L = st.pc.shape[0]
    n = n_shards
    per = L // n
    dev = st.pc.device
    i64 = torch.int64
    running = _running(st)
    occ = running.to(i64).reshape(n, per).sum(1)
    alive_c = st.alive.to(i64).reshape(n, per).sum(1)
    surplus, deficit, moved, donor_base, recv_base, recv_end = _plan_scalars(occ, alive_c, per)
    filled = torch.minimum(torch.clamp(moved - recv_base, min=0), deficit)

    shard = torch.arange(L, device=dev) // per
    keep = (occ - surplus)[shard]
    rank = (torch.cumsum(running.to(i64).reshape(n, per), 1) - 1).reshape(L)
    gidx = donor_base[shard] + rank - keep
    export = running & (rank >= keep) & (gidx < moved)
    dest = torch.clamp(torch.searchsorted(recv_end, gidx, right=True), max=n - 1)
    buf_pos = torch.where(export, dest * per + gidx - recv_base[dest], n * per)
    return StealPlan(export, buf_pos.to(I32), filled.to(I32), occ.to(I32), alive_c.to(I32), moved.to(I32))


def steal_plan(st: StateBatch, n_shards: int, device="cuda") -> StealPlan:
    """The work-steal plan of every shard (the steal kernel planning
    only, on the card)."""
    dev = _build.check_on(device, st.pc)
    if dev.type == "cpu":
        return steal_plan_plain(st, n_shards)
    from mythril_tpu_torch.laser.cuda import kernels

    a = kernels.MeshArgs(st, n_shards)
    _launch(a, kernels.MESH_PLAN)
    n = n_shards
    return StealPlan(a.export_.to(torch.bool), a.buf_pos, a.sh[2 * n:], a.sh[:n], a.sh[n:2 * n], a.mctl[1])


def steal_apply_plain(st: StateBatch, plan: StealPlan, n_shards: int) -> StateBatch:
    """Twin of K11 (mesh.py:178 ``steal_apply``): the exported rows land
    at lane ``alive_c[dest] + slot`` of their receiver's block (the
    other free lanes keep their stale rows), the exporters die with
    their counters zeroed. The result is not re-compacted."""
    L = st.pc.shape[0]
    per = L // n_shards
    src = torch.nonzero(plan.export).flatten()
    pos = plan.buf_pos[src].to(torch.int64)
    dest = pos // per
    tgt = dest * per + plan.alive_c[dest].to(torch.int64) + (pos - dest * per)
    out = []
    ex = plan.export
    for name, x in zip(StateBatch._fields, st):
        x = x.clone()
        if name == "alive":
            x = x & ~ex
        elif name in ("steps", "static_pruned"):
            x = torch.where(ex, 0, x)
        elif name == "visited":
            x = torch.where(ex[:, None], False, x)
        x[tgt] = getattr(st, name)[src]
        out.append(x)
    return StateBatch(*out)


def steal_apply(st: StateBatch, plan: StealPlan, n_shards: int, device="cuda") -> StateBatch:
    """Move the exported lanes of ``plan`` (the steal kernel moving from
    the given plan, ungated, on a copy on the card)."""
    dev = _build.check_on(device, st.pc, plan.buf_pos)
    if dev.type == "cpu":
        return steal_apply_plain(st, plan, n_shards)
    from mythril_tpu_torch.laser.cuda import kernels

    out = _clone(st)
    a = kernels.MeshArgs(out, n_shards)
    a.export_.copy_(plan.export.to(torch.uint8))
    a.buf_pos.copy_(plan.buf_pos)
    a.sh[n_shards:2 * n_shards].copy_(plan.alive_c)
    _launch(a, kernels.MESH_MOVE)
    return out


# -- the sync mesh tier ------------------------------------------------


def round_impl_plain(cb, st: StateBatch, steps_per_round: int = 64, do_rebalance: bool = False,
                     n_shards: int = 1):
    """Twin of ``round_impl``: the reference's GSPMD step sees all lanes,
    so forks are placed globally (``engine.run_plain``), then the deal
    and the occupancy."""
    if do_rebalance and n_shards < 2:
        raise ValueError("do_rebalance=True requires n_shards >= 2")
    out, _hist = engine.run_plain(cb, st, steps_per_round, False)
    if do_rebalance:
        out = rebalance_plain(out, n_shards)
    return out, occupancy_impl_plain(out, max(1, n_shards))


def round_impl(cb, env, st: StateBatch, steps_per_round: int = 64, do_rebalance: bool = False,
               n_shards: int = 1, device="cuda"):
    """One round of the sync mesh tier: up to ``steps_per_round`` steps
    while some lane runs (``engine.run``: one K1 launch on the card), then,
    with ``do_rebalance``, the deal (K12, in place on the copy that
    ``engine.run`` returned), then the per-shard occupancy (the steal
    kernel counting). Returns ``(st, occ)``; ``occ`` (i32[n_shards], on
    the device) is the host's one fetch per round for quiescence and the
    next round's rebalance gate. Nothing here syncs."""
    if do_rebalance and n_shards < 2:
        raise ValueError("do_rebalance=True requires n_shards >= 2")
    dev = _build.check_on(device, st.pc, cb.code)
    out = engine.run(cb, env, st, max_steps=steps_per_round, device=dev)
    if do_rebalance and out.pc.shape[0] % n_shards == 0:
        out = deal_(out, n_shards, device=dev)
    return out, occupancy_impl(out, max(1, n_shards), device=dev)


sharded_round = round_impl


# -- the fused mesh loop's steal (one launch, gated on the card) -------


def steal_round(a) -> None:
    """Between two rounds of the fused mesh loop, one launch of the steal
    kernel: it plans, decides (``mctl[0]``, counted into ``mctl[2..3]``)
    and moves the lanes when it said so. ``a`` is the loop's
    ``kernels.MeshArgs``; the launch reads the loop's control word and
    does nothing once the loop has ended."""
    from mythril_tpu_torch.laser.cuda import kernels

    _launch(a, kernels.MESH_STEAL_ROUND)


# -- the fused mesh loop's steal across cards (the cross-card exchange) --


def card_counts_plain(part: StateBatch, nl: int) -> torch.Tensor:
    """Twin of XC_COUNT on one card of ``nl`` shards: its shards'
    [running, alive] counts, i32[nl, 2]; the cards' rows in card order
    are every card's gathered buffer (the reference's all_gather,
    mesh.py:142)."""
    per = part.pc.shape[0] // nl
    run = _running(part).to(I32).reshape(nl, per).sum(1)
    return torch.stack([run, part.alive.to(I32).reshape(nl, per).sum(1)], 1).to(I32)


def _card_plan(counts: torch.Tensor, per: int):
    occ, alive_c = counts[:, 0].long(), counts[:, 1].long()
    surplus, deficit, moved, donor_base, recv_base, recv_end = _plan_scalars(occ, alive_c, per)
    go = int(moved) > 0 and int(occ.max()) - int(occ.min()) > 1
    return occ, alive_c, surplus, int(moved), donor_base, recv_base, recv_end, go


def card_plan_plain(part: StateBatch, counts: torch.Tensor, card: int, cards: int):
    """Twin of XC_PLAN on card ``card`` of ``cards``: from the gathered
    counts (i32[n, 2], alike on every card) the mesh's plan
    (``steal_plan_plain``'s on the joined batch), gated as the fused loop
    gates it (``moved > 0 and spread > 1``). When it steals, each of the
    card's exporters dies with its ``alive``, ``steps``,
    ``static_pruned`` and ``visited`` zeroed, and its row goes to lane
    ``alive_c[dest] + slot`` of dest's block where dest is one of the
    card's shards, else to row ``gidx - donor_base[first own shard]`` of
    the send batch. Returns (part, send, go, moved); ``send`` holds only
    the packed rows (zeros elsewhere; the card's buffer holds stale rows
    there, which nothing reads)."""
    n = counts.shape[0]
    nl = n // cards
    lc = part.pc.shape[0]
    per = lc // nl
    occ, alive_c, surplus, moved, donor_base, recv_base, recv_end, go = _card_plan(counts, per)
    send = StateBatch(*(torch.zeros_like(x) for x in part))
    if not go:
        return part, send, False, moved
    dev = part.pc.device
    running = _running(part)
    shard = card * nl + torch.arange(lc, device=dev) // per
    rank = (torch.cumsum(running.to(torch.int64).reshape(nl, per), 1) - 1).reshape(lc)
    gidx = donor_base[shard] + rank - (occ - surplus)[shard]
    export = running & (rank >= (occ - surplus)[shard]) & (gidx < moved)
    src = torch.nonzero(export).flatten()
    dest = torch.clamp(torch.searchsorted(recv_end, gidx[src], right=True), max=n - 1)
    own = dest // nl == card
    tgt = (dest - card * nl) * per + alive_c[dest] + gidx[src] - recv_base[dest]
    row = gidx[src] - donor_base[card * nl]
    out = []
    for name, x, y in zip(StateBatch._fields, part, send):
        x = x.clone()
        if name == "alive":
            x = x & ~export
        elif name in ("steps", "static_pruned"):
            x = torch.where(export, 0, x)
        elif name == "visited":
            x = torch.where(export[:, None], False, x)
        rows = getattr(part, name)[src]
        x[tgt[own]] = rows[own]
        y[row[~own]] = rows[~own]
        out.append(x)
    return StateBatch(*out), send, True, moved


def card_pull_plain(part: StateBatch, counts: torch.Tensor, card: int, sends) -> StateBatch:
    """Twin of XC_PULL on card ``card``: the card's imports, global
    receiver indices ``recv_base[first own shard]`` up to the lanes
    moved, land at lane ``alive_c[dest] + slot`` of their block, each
    from row ``gidx - donor_base[donor card's first shard]`` of its
    donor card's send batch, the donor shard being the one whose
    ``[donor_base, donor_base + surplus)`` holds gidx (the reference's
    place, mesh.py:221-224). Imports from the card's own shards were
    placed by XC_PLAN; nothing moves unless the plan steals."""
    cards = len(sends)
    n = counts.shape[0]
    nl = n // cards
    per = part.pc.shape[0] // nl
    occ, alive_c, surplus, moved, donor_base, recv_base, recv_end, go = _card_plan(counts, per)
    lo, hi = int(recv_base[card * nl]), min(moved, int(recv_end[card * nl + nl - 1]))
    if not go or hi <= lo:
        return part
    dev = part.pc.device
    gidx = torch.arange(lo, hi, device=dev)
    dest = torch.searchsorted(recv_end, gidx, right=True)
    tgt = (dest - card * nl) * per + alive_c[dest] + gidx - recv_base[dest]
    donor = torch.searchsorted(donor_base + surplus, gidx, right=True) // nl
    row = gidx - donor_base[donor * nl]
    out = [x.clone() for x in part]
    for dc in range(cards):
        sel = donor == dc
        if dc == card or not bool(sel.any()):
            continue
        for x, y in zip(out, sends[dc]):
            x[tgt[sel]] = y[row[sel]]
    return StateBatch(*out)


def exchange_plain(parts, n: int):
    """The cross-card exchange's twins in order on every card: the counts
    gathered, each card's plan and packing, each card's pull. Returns
    (parts, go, moved); the parts are not re-compacted."""
    cards = len(parts)
    counts = torch.cat([card_counts_plain(p, n // cards) for p in parts])
    planned = [card_plan_plain(p, counts, k, cards) for k, p in enumerate(parts)]
    sends = [pl[1] for pl in planned]
    out = PerCard(card_pull_plain(pl[0], counts, k, sends) for k, pl in enumerate(planned))
    return out, planned[0][2], planned[0][3]


class CardExchange:
    """The cross-card exchange of one fused mesh loop on the card, built
    once per super-round over the cards' batches (``parts``, updated in
    place by the loop) and control words: every card's send batch (its
    batch's shape), gathered buffer, held counts and steal word ``mctl``
    (i32[4], as ``kernels.MeshArgs``), and one ``kernels.CardArgs`` a
    card. Each step launches one mode on every card, under that card's
    device and on the stream current there when this was built:
    ``count`` (XC_COUNT) records event A of each card, ``plan`` (XC_PLAN)
    first makes each card's stream wait for every other stream's A and
    records B, ``pull`` (XC_PULL) waits for every B. No step syncs the
    host. Virtual cards of one device share its stream, where launch
    order is the ordering and no event is needed. It runs on CUDA cards
    only: on CPU cards ``megakernel.run_fused_mesh`` runs the twins
    (``exchange_plain``).

    Why one gathered buffer, one held buffer and one send batch a card
    suffice across rounds: card c's XC_COUNT of round r + 1 stores into
    card d's gathered buffer after c waited, in round r's pull, for d's
    B, which follows d's XC_PLAN of round r, the last reader of that
    buffer (XC_PULL reads the held copy XC_PLAN made); d's held buffer
    and send batch are read by XC_PULL of round r (d's own, and every
    other card's, which read d's send batch) before their next writer,
    d's XC_PLAN of round r + 1, which waits for every card's A of round
    r + 1, each recorded after that card's XC_PULL of round r. ``start``
    counts once more before the first round and derives each card's
    continue bit from its gathered buffer; its B events order that read
    before the first round's stores."""

    def __init__(self, parts, n: int, ctls, max_rounds: int):
        from mythril_tpu_torch.laser.cuda import kernels

        cards = len(parts)
        self.parts, self.n = list(parts), int(n)
        self.devs = [p.pc.device for p in parts]
        self.args, self.streams = [], []
        sends, gaths, helds, mctls = [], [], [], []
        for p, d in zip(parts, self.devs):
            with torch.cuda.device(d):
                sends.append(StateBatch(*(torch.empty_like(x) for x in p)))
                gaths.append(torch.zeros(2 * n, dtype=I32, device=d))
                helds.append(torch.zeros(2 * n, dtype=I32, device=d))
                mctls.append(torch.zeros(4, dtype=I32, device=d))
                self.streams.append(torch.cuda.current_stream(d))
        for k, (p, d) in enumerate(zip(parts, self.devs)):
            with torch.cuda.device(d):
                self.args.append(kernels.CardArgs(p, n, k, sends, gaths, helds[k], mctls[k], ctls[k], max_rounds))
        self.sends, self.gaths, self.helds, self.mctls = sends, gaths, helds, mctls
        self.ctls, self.max_rounds = ctls, int(max_rounds)
        # streams of distinct cards: order them with events
        self.ordered = len({s.cuda_stream for s in self.streams}) > 1
        self.ev_a = [torch.cuda.Event() for _ in range(cards)] if self.ordered else None
        self.ev_b = [torch.cuda.Event() for _ in range(cards)] if self.ordered else None

    def _wait(self, events, k: int) -> None:
        if self.ordered:
            for j, ev in enumerate(events):
                if self.streams[j].cuda_stream != self.streams[k].cuda_stream:
                    self.streams[k].wait_event(ev)

    def _record(self, events, k: int) -> None:
        if self.ordered:
            events[k].record(self.streams[k])

    def _launch(self, k: int, mode: int, ctl: bool = True) -> None:
        from mythril_tpu_torch.laser.cuda import kernels

        global xc_count_launches, xc_plan_launches, xc_pull_launches
        if mode == kernels.XC_COUNT:
            xc_count_launches += 1
        elif mode == kernels.XC_PLAN:
            xc_plan_launches += 1
        else:
            xc_pull_launches += 1
        kernels.launch_mesh_cards(self.args[k], mode, ctl)

    def start(self) -> None:
        """Before the first round: the counts, then each card's continue
        bit ``ctl[1]`` = some lane of the mesh runs and ``max_rounds`` > 0."""
        from mythril_tpu_torch.laser.cuda import kernels

        for k in range(len(self.args)):
            self._launch(k, kernels.XC_COUNT, ctl=False)
            self._record(self.ev_a, k)
        for k, d in enumerate(self.devs):
            self._wait(self.ev_a, k)
            with torch.cuda.device(d):
                self.ctls[k][1] = ((self.gaths[k][0::2].sum() > 0) & (self.max_rounds > 0)).to(I32)
            self._record(self.ev_b, k)
        for k in range(len(self.args)):
            self._wait(self.ev_b, k)

    def count(self) -> None:
        from mythril_tpu_torch.laser.cuda import kernels

        for k in range(len(self.args)):
            self._launch(k, kernels.XC_COUNT)
            self._record(self.ev_a, k)

    def plan(self) -> None:
        from mythril_tpu_torch.laser.cuda import kernels

        for k in range(len(self.args)):
            self._wait(self.ev_a, k)
            self._launch(k, kernels.XC_PLAN)
            self._record(self.ev_b, k)

    def pull(self) -> None:
        from mythril_tpu_torch.laser.cuda import kernels

        for k in range(len(self.args)):
            self._wait(self.ev_b, k)
            self._launch(k, kernels.XC_PULL)

    def steal_round(self) -> None:
        """Between two rounds: count, plan and pack, pull. The caller
        then runs each card's gated compaction (K4, on ``mctls[k]``)."""
        self.count()
        self.plan()
        self.pull()
