"""The fused super-round: K rounds of step -> prune -> kill -> compact.

Replaces ``mythril_tpu/laser/tpu/megakernel.py`` (single device):
``_fused_impl``, ``_one_round``, ``prune_mask`` and ``compact_impl``.
Each round runs ``steps_per_round`` steps (K1), the in-loop UNSAT screen
(K3) when ``with_solve`` is set, and the round epilogue (K4): REVERT
prune, in-loop kill, counter folds, ``pruned_visited`` union, zeroing of
the dying lanes' counters and a stable compaction that keeps survivors in
order. The loop runs while ``r < max_rounds`` and some lane is RUNNING;
the soundness arguments are the reference's.

On the card the reference's contract holds: ``run_fused`` queues
``max_rounds x (steps_per_round K1 + K3 + K4)`` launches with no host
sync, and the loop condition lives on the device in a control word
``ctl = [r, continue]`` that K4 rewrites after each round. Every kernel
reads it first and returns at once when the loop has ended, which is the
reference's ``while_loop`` condition evaluated between rounds. The only
host read is the caller's fetch of ``info``.

K4 (``csrc/megakernel.cu``) is two launches: ``epi_plan`` (one block,
L <= 1024) computes the prune/kill masks, folds the accumulators, ranks
survivors and writes the permutation and the next control word; then
``epi_gather`` (one block per destination lane) moves every plane's row
from its source lane into a scratch batch, zeroing the dying lanes'
counters and OR-ing their visited rows into ``pruned_visited``; the
scratch batch becomes the state with ``copy_`` on the same stream (a
device-to-device copy, no sync). Bound on the H100: bytes — the
compaction reads and writes every plane of the batch once.
"""

from typing import NamedTuple

import torch

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
    hist: torch.Tensor  # u32[1] placeholder (with_stats is not ported yet)


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


def round_epilogue_plain(cb: CodeBank, s: StateBatch, unsat, acc, pv):
    """Twin of the reference's per-round tail (megakernel.py:174-196).

    ``unsat`` is bool[L] (all False without the in-loop screen), ``acc``
    int32[4] = [pruned_lanes, pruned_steps, pruned_static, inloop_kills]
    and ``pv`` the pruned_visited plane; both are updated in place.
    Returns the compacted batch."""
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
    order = torch.argsort(s.alive.to(torch.int32), descending=True, stable=True)
    return StateBatch(*(x[order] for x in s))


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
    if with_stats:
        raise NotImplementedError("with_stats (op_hist_update, B8) is not ported yet")
    if pool is None:
        pool = inloop_solve.empty_pool(dev)
    L = st.pc.shape[0]
    n_codes, W = cb.code.shape
    pv = torch.zeros((n_codes, W), dtype=torch.bool, device=dev)
    acc = torch.zeros(4, dtype=torch.int32, device=dev)
    hist = torch.zeros(1, dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        return run_fused_plain(cb, st, max_rounds, steps_per_round, with_solve, pool)

    # card: everything queued, the loop condition on the device
    from mythril_tpu_torch.laser.cuda import kernels

    s = StateBatch(*(x.clone() for x in st))
    ctl = torch.zeros(4, dtype=torch.int32, device=dev)  # [r, continue, staged r, staged continue]
    ctl[1] = (_any_running(s) & (max_rounds > 0)).to(torch.int32)
    scratch = StateBatch(*(torch.empty_like(x) for x in s))
    unsat = torch.zeros(L, dtype=torch.bool, device=dev)
    args = kernels.StepArgs(cb, s)
    for _ in range(int(max_rounds)):
        for _ in range(steps_per_round):
            engine.step(cb, env, s, device=dev, ctl=ctl, inplace=True, args=args)
        if with_solve:
            inloop_solve.unsat_mask(pool, s, device=dev, ctl=ctl, out=unsat)
        round_epilogue(cb, s, unsat, acc, pv, ctl, max_rounds, scratch)
    return FusedOut(s, _info(ctl[0], acc, s), pv, hist)


def run_fused_plain(cb, st, max_rounds, steps_per_round, with_solve, pool) -> FusedOut:
    """The twin of the whole super-round, on any device (it syncs to
    evaluate the loop condition on the host)."""
    dev = st.pc.device
    L = st.pc.shape[0]
    pv = torch.zeros(cb.code.shape, dtype=torch.bool, device=dev)
    acc = torch.zeros(4, dtype=torch.int32, device=dev)
    r = 0
    s = st
    while r < max_rounds and bool(_any_running(s)):
        for _ in range(steps_per_round):
            s = engine.step_plain(cb, s)
        if with_solve:
            unsat = inloop_solve.unsat_mask_plain(pool, s)
        else:
            unsat = torch.zeros(L, dtype=torch.bool, device=dev)
        s = round_epilogue_plain(cb, s, unsat, acc, pv)
        r += 1
    hist = torch.zeros(1, dtype=torch.int32, device=dev)
    return FusedOut(s, _info(torch.tensor(r, device=dev), acc, s), pv, hist)


def round_epilogue(cb, s, unsat, acc, pv, ctl, max_rounds, scratch):
    """K4 on the card: prune/kill/fold/compact ``s`` in place, advance
    ``ctl``. ``unsat`` must be all False when the screen is off."""
    from mythril_tpu_torch.laser.cuda import kernels

    global launches
    launches += 1
    kernels.launch_epilogue(cb, s, unsat, acc, pv, ctl, int(max_rounds), scratch)


def decode_info(info) -> FusedStats:
    """ONE blocking device->host fetch for all fused-round scalars."""
    vals = info.detach().cpu().tolist()
    return FusedStats(*(int(v) for v in vals))
