"""Per-lane symbolic term tapes: host tables, node hashing and the
CSE-checked allocator.

Counterpart of ``mythril_tpu/laser/tpu/symtape.py``. The op codes, the
opcode -> node tables, the preimage-digest contract and the host helpers
are verbatim copies. ``node_hash`` and ``alloc`` (the reference's
``_alloc_impl``) are here as plain PyTorch twins; their CUDA side is
``csrc/symtape.cuh``, inlined into the step kernel (K1), which matches
them bit for bit: the same two murmur-style u32 hashes, and the same
CSE rule — the FIRST row whose (h1, h2) match is the only candidate, and
it is verified exactly, so a hash collision on an earlier row gives a
duplicate node exactly as the reference does.

u32 planes (``tape_h1``, ``tape_h2``, ``tape_meta``) are int32 tensors
holding the reference's bits; the twin widens them to int64 and masks
with ``& 0xFFFFFFFF``, since ``>>`` on int64 is arithmetic.
"""

import numpy as np
import torch

from mythril_tpu_torch.laser.cuda import words

ARG_NONE = 0
ARG_IMM = -1

# --- leaves -----------------------------------------------------------------
OP_OPAQUE = 2  # host-only term carried through; imm[0] = host-side ref index
OP_CDLOAD = 3  # 32-byte calldata read; a = offset (ref or ARG_IMM)
OP_CDSIZE = 4
OP_SLOAD = 5  # tx-initial storage read; a = key (ref or ARG_IMM)
OP_CALLER = 6
OP_CALLVALUE = 7
OP_ORIGIN = 8
OP_BALANCE = 9  # self-balance leaf
# --- 256-bit ALU ------------------------------------------------------------
OP_ADD = 10
OP_SUB = 11
OP_MUL = 12
OP_UDIV = 13
OP_SDIV = 14
OP_UREM = 15
OP_SREM = 16
OP_EXP = 17
OP_SIGNEXT = 18  # lhs = b (position), rhs = x (value), EVM operand order
OP_AND = 19
OP_OR = 20
OP_XOR = 21
OP_NOT = 22
OP_BYTE = 23  # lhs = index, rhs = word
OP_SHL = 24  # lhs = shift, rhs = value (EVM operand order)
OP_SHR = 25
OP_SAR = 26
# --- word-valued (0/1) comparisons ------------------------------------------
OP_LT = 27
OP_GT = 28
OP_SLT = 29
OP_SGT = 30
OP_EQ = 31
OP_ISZERO = 32
# --- keccak -----------------------------------------------------------------
OP_COMB = 33  # one 32-byte word of a keccak preimage; a = word, b = rest chain
OP_SHA3 = 34  # a = COMB chain; imm[0] = preimage byte length
# --- block/tx environment leaves --------------------------------------------
# Reads the host models as symbols (environment.py block_number/chainid,
# instructions.py _stamp_block_context): on device they retire as tape
# leaves and the bridge lifts each to the SAME term the host instruction
# would push, so constraints and taint annotations line up exactly.
OP_TIMESTAMP = 35
OP_NUMBER = 36
OP_DIFFICULTY = 37
OP_COINBASE = 38
OP_GASLIMIT = 39
OP_CHAINID = 40
OP_BASEFEE = 41
OP_GASPRICE = 42
OP_BLOCKHASH = 43  # a = queried block number (ref or ARG_IMM)
# a concrete 256-bit constant (imm): storage-event records reference
# concrete keys/values through CONST nodes so replayed detection hooks
# see EXACT words, not zero placeholders; CSE dedupes repeats
OP_CONST = 44

# EVM opcode byte -> (tape op, arity); 0 = this opcode never allocates.
SYM_OP = np.zeros(256, dtype=np.int32)
SYM_ARITY = np.zeros(256, dtype=np.int32)
for _byte, _top, _ar in [
    (0x01, OP_ADD, 2), (0x02, OP_MUL, 2), (0x03, OP_SUB, 2),
    (0x04, OP_UDIV, 2), (0x05, OP_SDIV, 2), (0x06, OP_UREM, 2),
    (0x07, OP_SREM, 2), (0x0A, OP_EXP, 2), (0x0B, OP_SIGNEXT, 2),
    (0x10, OP_LT, 2), (0x11, OP_GT, 2), (0x12, OP_SLT, 2),
    (0x13, OP_SGT, 2), (0x14, OP_EQ, 2), (0x15, OP_ISZERO, 1),
    (0x16, OP_AND, 2), (0x17, OP_OR, 2), (0x18, OP_XOR, 2),
    (0x19, OP_NOT, 1), (0x1A, OP_BYTE, 2), (0x1B, OP_SHL, 2),
    (0x1C, OP_SHR, 2), (0x1D, OP_SAR, 2),
]:
    SYM_OP[_byte] = _top
    SYM_ARITY[_byte] = _ar

# EVM opcode byte -> env-leaf tape op (0 = not an env leaf). These
# opcodes allocate a leaf node UNCONDITIONALLY when executed on device
# (the host pushes a symbol for them regardless of operand taggedness).
ENV_LEAF_OP = np.zeros(256, dtype=np.int32)
for _byte, _top in [
    (0x3A, OP_GASPRICE),
    (0x40, OP_BLOCKHASH),
    (0x41, OP_COINBASE),
    (0x42, OP_TIMESTAMP),
    (0x43, OP_NUMBER),
    (0x44, OP_DIFFICULTY),
    (0x45, OP_GASLIMIT),
    (0x46, OP_CHAINID),
    (0x48, OP_BASEFEE),
]:
    ENV_LEAF_OP[_byte] = _top



M32 = 0xFFFFFFFF
HASH_SEEDS = ((0x811C9DC5, 0x9E3779B1), (0x01000193, 0x85EBCA77))


def _mul32(x, mul: int):
    """(x * mul) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = x * (mul & 0xFFFF)
    hi = ((x * (mul >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mix(h, v, mul: int):
    h = _mul32((h ^ v) & M32, mul)
    return h ^ (h >> 16)


def node_hash(op, a, b, imm):
    """Two independent 32-bit identity hashes of a node.

    Accepts torch tensors (int64 results in [0, 2^32)) or numpy/python
    values (uint32 results, for host tape writers). ``imm``'s digit axis
    is the last axis."""
    if not isinstance(imm, torch.Tensor):
        h1, h2 = node_hash(
            torch.as_tensor(np.asarray(op, np.int64)),
            torch.as_tensor(np.asarray(a, np.int64)),
            torch.as_tensor(np.asarray(b, np.int64)),
            torch.as_tensor(np.asarray(imm, np.int64)),
        )
        return np.asarray(h1.numpy(), np.uint32), np.asarray(h2.numpy(), np.uint32)
    op32 = op.to(torch.int64) & M32
    a32 = a.to(torch.int64) & M32
    b32 = b.to(torch.int64) & M32
    imm32 = imm.to(torch.int64) & M32
    out = []
    for seed, mul in HASH_SEEDS:
        h = _mix((op32 + seed) & M32, a32, mul)
        h = _mix(h, b32, mul)
        for d in range(imm32.shape[-1]):
            h = _mix(h, imm32[..., d], mul)
        out.append(h)
    return out[0], out[1]


def path_fingerprint(h1, h2, signs):
    """Cumulative 64-bit fingerprints of a lane's branch-condition
    prefix: entry j identifies the constraint prefix of length j+1.

    Chained (order-sensitive) over the per-node identity hashes
    (node_hash planes) and branch signs, so forked siblings — which
    share the parent's tape and therefore the parent's (h1, h2, sign)
    sequence verbatim — produce IDENTICAL prefix entries. The solver
    cache keys warm-start models by these: a child looks up the nearest
    ancestor fingerprint to seed the device search from the parent
    path's model (hint only — never a verdict key).

    Host-side numpy; returns uint64[n]."""
    h1 = np.asarray(h1, dtype=np.uint64)
    h2 = np.asarray(h2, dtype=np.uint64)
    signs = np.asarray(signs, dtype=np.uint64)
    out = np.zeros(h1.shape[0], dtype=np.uint64)
    acc = np.uint64(0xCBF29CE484222325)
    mul = np.uint64(0xBF58476D1CE4E5B9)
    with np.errstate(over="ignore"):
        for j in range(h1.shape[0]):
            v = (h1[j] << np.uint64(33)) ^ (h2[j] << np.uint64(1)) ^ signs[j]
            acc = (acc ^ v) * mul
            acc = acc ^ (acc >> np.uint64(29))
            out[j] = acc
    return out


# --- keccak preimage digests ------------------------------------------------
# OP_SHA3 imm digits 0..DIGEST_LO-1 carry the preimage BYTE LENGTH (the
# words.from_int low half); digits DIGEST_LO..15 carry a 128-bit content
# digest of the canonical preimage encoding below. The digest is a pure
# function of the preimage's content (concrete bytes / symbolic-word
# identity hashes), computed identically by the device engine
# (engine ``do_sha_sym`` via keccak256_batch) and the host packer
# (bridge._lower_keccak via support.keccak), so a SHA3 node lowered on
# the host and one allocated on device CSE-match, and storage keys
# rooted at structurally identical keccak preimages unify WITHOUT a
# host round trip. Digest 0 means "no digest recorded" (legacy nodes,
# unrepresentable preimages): consumers MUST fall back to node-id
# identity and never treat two zero digests as equal content.
#
# Canonical encoding: one DIGEST_RECORD_BYTES-byte record per 32-byte
# preimage word, preimage order, then digest128 = first 16 bytes of
# keccak256(records):
#   byte 0       1 if the word is symbolic else 0
#   bytes 1..32  symbolic: h1 (4B BE) + h2 (4B BE) + 24 zero bytes
#                concrete: the raw word, big-endian

DIGEST_RECORD_BYTES = 33
DIGEST_LO = 8  # first imm digit of the digest
DIGEST_DIGITS = 8  # 8 digits x 16 bits = 128-bit digest


def digest_digits(digest16) -> np.ndarray:
    """Pack the first 16 digest bytes into 8 imm digits (host numpy):
    digit d = (byte[2d] << 8) | byte[2d+1], matching the device packer
    in engine.py."""
    b = np.frombuffer(bytes(digest16[:16]), dtype=np.uint8).astype(np.uint32)
    return (b[0::2] << np.uint32(8)) | b[1::2]


def sha3_imm(nbytes: int, digest16=None) -> np.ndarray:
    """The canonical OP_SHA3 imm word: preimage byte length in the low
    digits, optional 128-bit content digest in digits DIGEST_LO..15."""
    imm = words.from_int(int(nbytes))
    if digest16 is not None:
        imm[DIGEST_LO : DIGEST_LO + DIGEST_DIGITS] = digest_digits(digest16)
    return imm


def key_digest_host(ops, aa, bb, imm3, node_id) -> np.ndarray:
    """uint32[DIGEST_DIGITS] content digest of a storage-key node, host
    mirror of the engine's in-loop probe-digest logic. Zeros = no digest.

    Accepts a direct OP_SHA3 node (digest straight off the imm) or the
    derived mapping-value form OP_ADD(sha3-ref, imm) with the offset
    below 2^128, whose digest is base + offset mod 2^128 — the same
    definition the device uses, so host-stamped storage entries and
    device probes agree."""
    i = int(node_id) - 1
    if i < 0:
        return np.zeros(DIGEST_DIGITS, np.uint32)
    op = int(ops[i])
    if op == OP_SHA3:
        return np.asarray(imm3[i][DIGEST_LO:], np.uint32).copy()
    if op == OP_ADD:
        a_, b_ = int(aa[i]), int(bb[i])
        ref, other = (a_, b_) if a_ > 0 else (b_, a_)
        if ref > 0 and other == ARG_IMM and int(ops[ref - 1]) == OP_SHA3:
            off = np.asarray(imm3[i], np.uint64)
            base = np.asarray(imm3[ref - 1][DIGEST_LO:], np.uint64)
            if int(off[DIGEST_LO:].sum()) == 0 and int(base.sum()) != 0:
                out = np.zeros(DIGEST_DIGITS, np.uint32)
                carry = 0
                for d in range(DIGEST_DIGITS):
                    s = int(base[d]) + int(off[d]) + carry
                    out[d] = s & 0xFFFF
                    carry = s >> 16
                return out
    return np.zeros(DIGEST_DIGITS, np.uint32)


HOST_META = 0xFFFFFFFF  # tape_meta sentinel: node packed by the host


def pack_meta(pc, path_len):
    """Allocation-site metadata word (int64 in [0, 2^32)): pc in the low
    16 bits, the path tape length at allocation time above."""
    return ((pc.to(torch.int64) & 0xFFFF) | (path_len.to(torch.int64) << 16)) & M32


def unpack_meta(meta: int):
    """(pc, path_len) of a device-allocated node; None for HOST_META."""
    if meta == HOST_META:
        return None
    return int(meta) & 0xFFFF, int(meta) >> 16


TAPE_FIELDS = (
    "tape_op", "tape_a", "tape_b", "tape_imm", "tape_h1", "tape_h2",
    "tape_meta", "tape_len",
)


def alloc(tapes: dict, mask, op, a, b, imm, meta):
    """Append one node per masked lane, with per-lane CSE (twin).

    ``tapes`` maps the TAPE_FIELDS names to the batch's planes (int32 /
    int32-bits-of-u32 tensors); it is updated in place. ``op/a/b`` are
    [L] ints, ``imm`` [L, 16] digits, ``meta`` [L] u32 values. Returns
    ``(id1, ok)``: the 1-based node id (an existing row on a CSE hit,
    0 where ``mask`` is False) and False where the tape is full."""
    tape_op = tapes["tape_op"]
    L, T = tape_op.shape
    D = imm.shape[-1]
    dev = tape_op.device
    lane = torch.arange(L, device=dev)
    slot = torch.arange(T, device=dev)[None, :]
    tape_len = tapes["tape_len"].to(torch.int64)
    ti3 = tapes["tape_imm"].view(L, T, D)
    op = op.to(torch.int64)
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    imm = imm.to(torch.int64)

    h1, h2 = node_hash(op, a, b, imm)
    live = slot < tape_len[:, None]
    same = (
        live
        & (words.from_plane(tapes["tape_h1"]) == h1[:, None])
        & (words.from_plane(tapes["tape_h2"]) == h2[:, None])
    )
    cand_any = same.any(dim=-1)
    cand = same.to(torch.int8).argmax(dim=-1)
    hit = (
        cand_any
        & (tape_op[lane, cand].to(torch.int64) == op)
        & (tapes["tape_a"][lane, cand].to(torch.int64) == a)
        & (tapes["tape_b"][lane, cand].to(torch.int64) == b)
        & (ti3[lane, cand].to(torch.int64) == imm).all(dim=-1)
    )
    overflow = tape_len >= T
    do_new = mask & ~hit & ~overflow
    widx = tape_len.clamp(0, T - 1)
    rows = lane[do_new]
    cols = widx[do_new]
    tapes["tape_op"][rows, cols] = op[do_new].to(torch.int32)
    tapes["tape_a"][rows, cols] = a[do_new].to(torch.int32)
    tapes["tape_b"][rows, cols] = b[do_new].to(torch.int32)
    tapes["tape_h1"][rows, cols] = words.to_plane(h1[do_new])
    tapes["tape_h2"][rows, cols] = words.to_plane(h2[do_new])
    tapes["tape_meta"][rows, cols] = words.to_plane(meta.to(torch.int64)[do_new])
    ti3[rows, cols] = words.to_plane(imm[do_new])
    tapes["tape_len"] = (tape_len + do_new.to(torch.int64)).to(torch.int32)
    id1 = torch.where(mask, torch.where(hit, cand, tape_len) + 1, 0)
    ok = ~mask | hit | ~overflow
    return id1, ok
