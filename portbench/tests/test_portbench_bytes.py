"""The frozen byte counts, pinned to counts worked out by hand at
DEFAULT_BATCH_CFG (512 lanes, code 8192)."""

from portbench import bytes as nb
from portbench.reference import lanes

CFG = lanes.DEFAULT_BATCH_CFG


def test_row_bytes():
    assert nb.row_bytes(CFG) == 36148  # the sum of every plane's bytes a lane


def test_pool_bytes():
    # 64 vars x two u32 hashes + 64 clauses x 8 literals x (i32 var, neg, used)
    assert nb.pool_bytes() == 512 + 3072


def test_k1_handoff_bytes():
    # bectoken.frontier: 128 seeded rows read, 512 rows written, the
    # 131-byte contract's bank (69 bytes a pc) read once
    assert nb.k1_handoff_bytes(CFG, 131, 128, 512) == 640 * 36148 + 131 * 69 == 23143759


def test_epilogue_handoff_bytes():
    # a round: 512 lanes x (K3 6 + K4 19) + the pool 3584 = 16384
    assert nb.epilogue_handoff_bytes(CFG, 1, 0, nb.pool_bytes()) == 16384
    # two rounds, 10 lanes dying: each one's coverage row (8192) read and cleared
    assert nb.epilogue_handoff_bytes(CFG, 2, 10, nb.pool_bytes()) == 2 * 16384 + 10 * 2 * 8192 == 196608
