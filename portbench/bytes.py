"""Bytes the kernels of a hand-off must move, from the batch's shape and
the rows a hand-off touches, and the least time they take at the card's
peak memory rate. Each input byte is counted as read once and each output
byte as written once, whatever the kernel reads again, so a share of
this bound can only be low, never above 100 %.

The ``*_handoff_bytes`` functions are what the per-layer metrics divide
by, over the K1 / K3 + K4 launches of a hand-off taken as one unit.
"""

import numpy as np

from portbench.reference import lanes

# the code bank's bytes per byte-pc: code, push_imm (16 u32 digits),
# jumpdest, must_revert, swc_mask, jumpi_verdict
BANK_BYTES_PER_PC = 1 + 64 + 1 + 1 + 1 + 1
# K4 per lane and launch: the flag and counter planes it plans from
K4_LANE_BYTES = 1 + 4 + 4 + 1 + 1 + 4 + 4
# K3 per lane and launch: the mask written and the flags read
K3_LANE_BYTES = 1 + 4 + 1


def row_bytes(cfg) -> int:
    """One lane's bytes over every plane of the batch."""
    return int(sum(int(np.prod(shape[1:], dtype=np.int64)) * np.dtype(dt).itemsize
                   for shape, dt in lanes.batch_shapes(cfg).values()))


def pool_bytes(vars_: int = 64, clauses: int = 64, width: int = 8) -> int:
    return vars_ * 4 * 2 + clauses * width * (4 + 1 + 1)


def k1_handoff_bytes(cfg, code_len_used: int, seed_rows: int, end_rows: int) -> int:
    """The K1 launches of a hand-off: every seeded row read once, the
    contract's bank read once, every row the hand-off ends with (alive,
    or pruned and killed on the way) written once."""
    return (seed_rows + end_rows) * row_bytes(cfg) + code_len_used * BANK_BYTES_PER_PC


def epilogue_handoff_bytes(cfg, rounds: int, dying: int, pool: int) -> int:
    """The K3 and K4 launches of a hand-off's retired rounds: each
    launch's flag planes, the pool once a K3 launch, and each dying
    lane's coverage row read and cleared; rows that compaction moves are
    not counted (the lower bound takes none)."""
    return rounds * (cfg.lanes * (K3_LANE_BYTES + K4_LANE_BYTES) + pool) + dying * 2 * cfg.code_len


def least_ms(nbytes: int, bytes_per_s: float) -> float:
    return nbytes / bytes_per_s * 1e3
