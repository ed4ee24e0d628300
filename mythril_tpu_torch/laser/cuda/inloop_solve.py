"""In-loop propagation-only UNSAT screen: the device kernel (K3) and its twin.

Replaces ``mythril_tpu/laser/tpu/inloop_solve.py`` ``unsat_mask``. A
RUNNING lane is flagged when its path condition is provably UNSAT by
rule R1 (one node asserted with both signs), R3 (``u`` and
``ISZERO(u)`` asserted with the same sign), or by ``PROP_SWEEPS`` unit
propagation sweeps over the host-seeded clause pool (path entries
matched to pool variables by their (h1, h2) identity hashes). The
soundness argument is the reference's: every kill is subsumed by a
host must-UNSAT verdict.

The reference folds the forced literals back onto the variables with a
bool-as-f32 matmul; both the twin and the kernel fold them with boolean
ORs, which is the same function exactly.

Kernel (``csrc/inloop.cu``): one warp per lane. The warp stages the
lane's P path entries and their tape nodes in shared memory, tests R1/R3
with each thread taking its entries against all of them, seeds the
V-entry assignment in shared memory, and runs each sweep with each
thread taking its clauses against the sweep-start assignment, the
forced literals applied by each var's owner after a warp barrier. Each
block first copies the pool (small and shared by every lane) into its
shared memory. Bound on the H100: bytes, below a launch's own latency at
the main path's shapes.
"""

from typing import NamedTuple

import torch

from mythril_tpu_torch.laser.cuda import _build, symtape
from mythril_tpu_torch.laser.cuda.batch import RUNNING, StateBatch

PROP_SWEEPS = 2
POOL_VARS = 64
POOL_CLAUSES = 64
POOL_WIDTH = 8

launches = 0  # K3 launches (CUDA path only)


class InloopPool(NamedTuple):
    """Fixed-shape CNF pool (reference field names and dtypes; var
    hashes are int32 tensors holding the u32 bits)."""

    var_h1: torch.Tensor  # u32[V]
    var_h2: torch.Tensor  # u32[V]
    lit_var: torch.Tensor  # i32[C, W]
    lit_neg: torch.Tensor  # bool[C, W]
    lit_used: torch.Tensor  # bool[C, W]


def make_pool(var_h1, var_h2, lit_var, lit_neg, lit_used, device="cuda") -> InloopPool:
    """Assemble a pool on ``device`` from host values (lists or numpy):
    u32 hashes as int32 tensors with the same bits. The solver cache
    builds it on the CPU; ``transfer.pool_to_device`` pins it on the card
    once per super-round."""
    from mythril_tpu_torch.laser.cuda import convert

    dev = _build.resolve_device(device)
    return InloopPool(
        var_h1=convert.to_tensor(var_h1, convert.POOL_DTYPES["var_h1"], dev),
        var_h2=convert.to_tensor(var_h2, convert.POOL_DTYPES["var_h2"], dev),
        lit_var=convert.to_tensor(lit_var, convert.POOL_DTYPES["lit_var"], dev),
        lit_neg=convert.to_tensor(lit_neg, convert.POOL_DTYPES["lit_neg"], dev),
        lit_used=convert.to_tensor(lit_used, convert.POOL_DTYPES["lit_used"], dev),
    )


def empty_pool(device="cuda") -> InloopPool:
    """The no-clauses pool: R1/R3 still fire, propagation is a no-op."""
    dev = _build.resolve_device(device)
    return InloopPool(
        var_h1=torch.zeros((1,), dtype=torch.int32, device=dev),
        var_h2=torch.zeros((1,), dtype=torch.int32, device=dev),
        lit_var=torch.zeros((1, 1), dtype=torch.int32, device=dev),
        lit_neg=torch.zeros((1, 1), dtype=torch.bool, device=dev),
        lit_used=torch.zeros((1, 1), dtype=torch.bool, device=dev),
    )


def unsat_mask_plain(pool: InloopPool, s: StateBatch) -> torch.Tensor:
    """Plain PyTorch twin of the reference ``unsat_mask``: bool[L]."""
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
    # the reference's gather wraps negative indices once, then clamps
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


def unsat_mask(pool: InloopPool, s: StateBatch, device="cuda", ctl=None, out=None, args=None) -> torch.Tensor:
    """bool[L]: RUNNING lanes whose path condition is provably UNSAT.

    ``ctl`` (CUDA only) is the fused loop's control word: the kernel
    leaves ``out`` untouched once the loop has ended. ``args`` (CUDA
    only) is a ``kernels.UnsatArgs`` a loop built once for these
    arguments."""
    _build.check_on(device, s.path_id, pool.var_h1)
    if s.path_id.device.type == "cpu":
        return unsat_mask_plain(pool, s)
    from mythril_tpu_torch.laser.cuda import kernels

    global launches
    launches += 1
    return kernels.launch_unsat(pool, s, ctl, out, args)
