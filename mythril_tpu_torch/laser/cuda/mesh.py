"""The mesh tiers on one card: n lane shards, the work-steal and the deal.

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

Here a mesh of n shards is n contiguous blocks of ``per = L / n`` lanes
of one batch on one card, as the reference's tests and its multichip
evidence run it on n virtual devices of one host. What crossed devices
becomes two CUDA kernels (``csrc/mesh.cu``):

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

Each has a plain twin (``*_plain``), which the wrappers run on CPU
tensors. Spreading the shards over several cards (NCCL for the counts'
all_gather and the exchange) is transport, not a kernel, and waits for
a machine with more than one card; until then ``n_devices`` is 1.
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


class Mesh(NamedTuple):
    """n lane shards of one batch on one torch device."""

    n: int
    device: torch.device


def n_devices(device="cuda") -> int:
    """The counterpart of the reference's ``len(jax.devices())``: the
    devices a mesh spans. Every shard of a ``Mesh`` lies on the one
    device, so this is 1 on any host, and the backend stays on the
    single-device tiers: a mesh of n shards on one card would only add
    per-shard fork limits and the steal's launches. The tests and
    ``chip_smoke.py`` patch it to 8, as the reference's tests force 8
    virtual devices."""
    return 1


@lru_cache(maxsize=None)
def _mesh_cached(n: int, device: str) -> Mesh:
    return Mesh(n, torch.device(device))


def make_mesh(n_devices_: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh of ``n_devices_`` shards (default: ``n_devices()``) on
    ``device``, cached per size as the reference caches its Mesh."""
    n = n_devices(device) if n_devices_ is None else n_devices_
    return _mesh_cached(int(n), str(torch.device(device)))


def shard_batch(st: StateBatch, mesh: Mesh) -> StateBatch:
    """The batch on the mesh's device (its lane blocks are the shards)."""
    return StateBatch(*(x.to(mesh.device) for x in st))


def put_replicated(tree, mesh: Mesh):
    """A tuple or NamedTuple of tensors (code bank, env, pool) on the
    mesh's device."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if isinstance(tree, tuple):
        items = [put_replicated(x, mesh) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


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
    free = per - alive_c
    total = occ.sum()
    base = total // n
    rem = total - base * n
    target = base + (torch.arange(n, device=dev) < rem).to(i64)
    surplus = torch.clamp(occ - target, min=0)
    deficit = torch.minimum(torch.clamp(target - occ, min=0), free)
    moved = torch.minimum(surplus.sum(), deficit.sum())
    donor_base = torch.cumsum(surplus, 0) - surplus
    recv_base = torch.cumsum(deficit, 0) - deficit
    recv_end = torch.cumsum(deficit, 0)
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
