"""Frozen copy of the port's plain fused super-round and in-loop screen.

Copied from ``mythril_tpu_torch/laser/cuda/megakernel.py``
(``prune_mask``, ``compact_plain``, ``round_epilogue_plain``,
``run_fused_plain``) and ``inloop_solve.py`` (``unsat_mask_plain``), one
shard only. A round runs ``steps_per_round`` steps (K1), the
propagation-only UNSAT screen (K3) and the round epilogue (K4): REVERT
prune, in-loop kill, counter folds, the ``pruned_visited`` union, zeroing
of the dying lanes' counters and a stable compaction. The loop runs
while ``r < max_rounds`` and some lane is RUNNING.

One departure from the program's twin: a round stops stepping once no
lane runs, as the card's K1 launch does. A step with no running lane
changes nothing, so the result is the same; the tests hold the two
forms equal.
"""

from typing import NamedTuple

import torch

from portbench.reference import engine, symtape
from portbench.reference.lanes import REVERTED, RUNNING, TRAP, CodeBank, StateBatch

REVERT_OP = 0xFD
PROP_SWEEPS = 2
# the program's pool is always built at full capacity (solver_cache.build_inloop_pool)
POOL_VARS = 64
POOL_CLAUSES = 64
POOL_WIDTH = 8


class InloopPool(NamedTuple):
    var_h1: torch.Tensor  # u32[V] as int32 bits
    var_h2: torch.Tensor
    lit_var: torch.Tensor  # i32[C, W]
    lit_neg: torch.Tensor  # bool[C, W]
    lit_used: torch.Tensor  # bool[C, W]


def clause_free_pool(device) -> InloopPool:
    """The pool a process with no recorded must-UNSAT facts builds: every
    clause slot unused, so only the syntactic rules R1/R3 fire."""
    V, C, W = POOL_VARS, POOL_CLAUSES, POOL_WIDTH
    return InloopPool(
        var_h1=torch.zeros((V,), dtype=torch.int32, device=device),
        var_h2=torch.zeros((V,), dtype=torch.int32, device=device),
        lit_var=torch.zeros((C, W), dtype=torch.int32, device=device),
        lit_neg=torch.zeros((C, W), dtype=torch.bool, device=device),
        lit_used=torch.zeros((C, W), dtype=torch.bool, device=device),
    )


def unsat_mask_plain(pool: InloopPool, s: StateBatch) -> torch.Tensor:
    """bool[L]: RUNNING lanes whose path condition is provably UNSAT (R1:
    one node asserted with both signs; R3: ``u`` and ``ISZERO(u)`` with
    the same sign; or PROP_SWEEPS unit-propagation sweeps over the pool)."""
    L, Pn = s.path_id.shape
    T = s.tape_op.shape[1]
    dev = s.path_id.device
    lane = torch.arange(L, device=dev)[:, None]
    ids = s.path_id.to(torch.int64)
    valid = (torch.arange(Pn, device=dev)[None, :] < s.path_len[:, None]) & (ids > 0)
    idx = (ids - 1).clamp(0, T - 1)
    sign = s.path_sign

    pair = valid[:, :, None] & valid[:, None, :]
    r1 = (pair & (ids[:, :, None] == ids[:, None, :]) & (sign[:, :, None] != sign[:, None, :])).flatten(1).any(-1)

    ent_op = s.tape_op[lane, idx]
    ent_a = s.tape_a[lane, idx].to(torch.int64)
    is_isz = valid & (ent_op == symtape.OP_ISZERO) & (ent_a > 0)
    r3 = (
        is_isz[:, :, None]
        & valid[:, None, :]
        & (ent_a[:, :, None] == ids[:, None, :])
        & (sign[:, :, None] == sign[:, None, :])
    ).flatten(1).any(-1)

    V = pool.var_h1.shape[0]
    h1 = s.tape_h1[lane, idx]
    h2 = s.tape_h2[lane, idx]
    match = (
        valid[:, :, None]
        & (h1[:, :, None] == pool.var_h1[None, None, :])
        & (h2[:, :, None] == pool.var_h2[None, None, :])
    )
    pos = (match & sign[:, :, None]).any(1)
    neg = (match & ~sign[:, :, None]).any(1)
    assign = pos.to(torch.int8) - neg.to(torch.int8)  # [L, V]

    lit_var = pool.lit_var.to(torch.int64)
    lit_oh = (lit_var[:, :, None] == torch.arange(V, device=dev)[None, None, :]) & pool.lit_used[:, :, None]
    gather_idx = torch.where(lit_var < 0, lit_var + V, lit_var).clamp(0, V - 1)
    n_used = pool.lit_used.to(torch.int64).sum(-1)
    clause_active = n_used > 0
    conflict = torch.zeros(L, dtype=torch.bool, device=dev)
    for _ in range(PROP_SWEEPS):
        lv = assign[:, gather_idx]  # [L, C, W]
        lit_true = torch.where(pool.lit_neg, lv < 0, lv > 0) & pool.lit_used
        lit_false = torch.where(pool.lit_neg, lv > 0, lv < 0) & pool.lit_used
        n_true = lit_true.to(torch.int64).sum(-1)
        n_false = lit_false.to(torch.int64).sum(-1)
        conflict = conflict | (clause_active & (n_true == 0) & (n_false == n_used)).any(-1)
        unit = clause_active & (n_true == 0) & (n_false == (n_used - 1))
        open_lit = pool.lit_used & ~lit_true & ~lit_false
        force_pos = unit[:, :, None] & open_lit & ~pool.lit_neg  # [L, C, W]
        force_neg = unit[:, :, None] & open_lit & pool.lit_neg
        fp = (force_pos[:, :, :, None] & lit_oh[None]).flatten(1, 2).any(1)  # [L, V]
        fn = (force_neg[:, :, :, None] & lit_oh[None]).flatten(1, 2).any(1)
        conflict = conflict | ((fp & (assign < 0)) | (fn & (assign > 0)) | (fp & fn)).any(-1)
        assign = torch.where(fp & (assign == 0), torch.ones_like(assign), assign)
        assign = torch.where(fn & (assign == 0), -torch.ones_like(assign), assign)
    return (r1 | r3 | conflict) & s.alive & (s.status == RUNNING)


def prune_mask(cb: CodeBank, st: StateBatch) -> torch.Tensor:
    at_revert = (st.status == REVERTED) | ((st.status == TRAP) & (st.trap_op == REVERT_OP))
    return st.alive & st.outermost & cb.prune_revert & at_revert


def compact_plain(s: StateBatch) -> StateBatch:
    """A stable sort on the dead flag: survivors first, in order."""
    order = torch.argsort(s.alive.to(torch.int32), descending=True, stable=True)
    return StateBatch(*(x[order] for x in s))


def round_epilogue_plain(cb: CodeBank, s: StateBatch, unsat, acc, pv):
    """The round's tail. ``acc`` int32[4] = [pruned_lanes, pruned_steps,
    pruned_static, inloop_kills] and ``pv`` are updated in place."""
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
    return compact_plain(s)


def any_running(s: StateBatch) -> bool:
    return bool((s.alive & (s.status == RUNNING)).any())


def _dropping_forks(step):
    """``step`` with each lane that a fork fills in that step left dead:
    the taken branch of a symbolic JUMPI is lost, the fall-through goes
    on."""

    def dropping(cb, s):
        out = step(cb, s)
        return out._replace(alive=out.alive & s.alive)

    return dropping


class FusedOut(NamedTuple):
    st: StateBatch
    # [rounds_done, pruned_lanes, pruned_steps, pruned_static, n_alive, n_running, inloop_kills]
    info: list
    pruned_visited: torch.Tensor  # bool[n_codes, code_len]


def run_fused_plain(cb, st, max_rounds, steps_per_round, with_solve, pool, step=None, check_every=16,
                    keep_forks=True) -> FusedOut:
    """The whole super-round. ``step`` replaces ``engine.step_plain`` and
    ``keep_forks=False`` drops every fork child as it is placed (the
    benchmark's controls); the round leaves its steps once no lane runs,
    looked at every ``check_every`` steps."""
    step = engine.step_plain if step is None else step
    if not keep_forks:
        step = _dropping_forks(step)
    dev = st.pc.device
    L = st.pc.shape[0]
    pv = torch.zeros(cb.code.shape, dtype=torch.bool, device=dev)
    acc = torch.zeros(4, dtype=torch.int32, device=dev)
    r = 0
    s = st
    while r < max_rounds and any_running(s):
        for t in range(steps_per_round):
            if t % check_every == 0 and t and not any_running(s):
                break
            s = step(cb, s)
        if with_solve:
            unsat = unsat_mask_plain(pool, s)
        else:
            unsat = torch.zeros(L, dtype=torch.bool, device=dev)
        s = round_epilogue_plain(cb, s, unsat, acc, pv)
        r += 1
    n_alive = int(s.alive.sum())
    n_running = int((s.alive & (s.status == RUNNING)).sum())
    a = [int(v) for v in acc.tolist()]
    return FusedOut(s, [r, a[0], a[1], a[2], n_alive, n_running, a[3]], pv)
