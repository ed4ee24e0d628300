"""The batched symbolic-EVM step: the device kernel (K1) and its plain twin.

Replaces ``mythril_tpu/laser/tpu/engine.py`` ``step_impl`` (jitted as
``step``), with ``words.*``, ``keccak_tpu.keccak256_batch`` and
``symtape._alloc_impl`` inlined. One call advances every lane by one EVM
instruction: fetch, gas, the ALU families, tape allocation for symbolic
operands, memory/calldata gathers, the storage probe and event ring,
SHA3, DUP/SWAP, JUMP/JUMPI with the static MUST facts, status, commit,
and JUMPI forks into free lanes. The semantics (and every quirk, such as
the first-match CSE and the rows that a trapping lane leaves past its
``tape_len``) are the reference's; see that module's comments.

``step_plain`` is the plain PyTorch twin, written over the whole batch
as the reference is. Its any-lane gates (the reference's ``lax.cond``
at engine.py:272, 301, 323, 333, 434, 711, 798 and 1364) become "compute
on the lanes that need it"; a lane outside the gate never commits the
value, so the result is the same.

The kernel (``csrc/step.cu``, ``csrc/step.cuh``) runs ``n_steps`` steps
in one cooperative launch, as the reference's round runs
``steps_per_round`` in one ``lax.fori_loop`` (megakernel.py:165). Fork
placement is the one part that crosses lanes (whether a forking parent
commits depends on its block's free-lane count and its rank,
engine.py:1004-1009), so each step is three phases behind grid
barriers:

1. every lane's flags (free, fork request, running) from the pre-step
   state into scratch;
2. the fork rank: each block scans the flags in shared memory (a warp
   shuffle scan; no thread walks more than L / 128 lanes) and gives the
   r-th request of a lane block its r-th free lane, or none. With no lane
   running the launch ends: no later step could change anything;
3. the lane pass: one warp per lane. Its
   first thread steps the lane in place, hashing a concrete SHA3 from the
   lane's own pre-step memory (the reference's ``do_sha`` and
   ``keccak256_batch``, engine.py:784-793); then the warp copies a
   committed forking parent's post-step row into its child and applies
   the child's own edits (pc, last path sign, landing ring, prune
   counter). The child was free when the step began and is skipped by
   its owner on the step's flags, so no barrier separates copy and lane
   pass.

``step`` is one launch of one step (one ctypes call); ``step_n`` one
launch of ``n_steps``, which the fused loops issue once per round and the
sync slice loop once per slice. Given ``hist``, the launch is K1's stats
instance, which also folds every step's retired opcodes into it (see
below). K2 is not launched by the step: it stays for callers that hash
rows alone.

Bound on the H100: bytes. A step reads each running lane's fetch,
operands and the planes its opcode touches; the forced minimum is far
below the kernel's real traffic (one thread walks its lane's tape for
CSE and its storage slots), and at the main path's shapes the kernel is
latency-bound (the slowest lane's serial step and two grid barriers per
step). A launch first reads the fused loop's control word and returns at
once once the loop has ended.

Stats mode and the sync slice loop (B8 and B10) live here too:

- ``op_hist_update`` (K8, ``csrc/hist.cu``; the reference's
  engine.py:1398) adds one step's retired opcodes into a u32[256]
  histogram, held as int32 bits. A lane retired ``code[pc]`` iff its
  step counter advanced. It is the standalone counterpart of the
  reference's function: on the card the loops do not launch it, since
  K1's stats instance folds the same bins inside its launch after every
  step (``step_n(..., hist=)``), each lane recorded from its own pre-step
  row before any fork copies into it.
- ``run`` and ``run_with_stats`` (the reference's ``_run_impl``,
  engine.py:1415) step the batch while ``t < max_steps`` and some lane
  is alive and RUNNING, the condition evaluated before each step. On
  the card that is one K1 launch of ``max_steps`` steps (with the
  histogram for ``run_with_stats``): K1 leaves once no lane is alive and
  RUNNING, which is that very condition. ``any_running`` is the caller's
  one quiescence read per slice: K9 (``csrc/slice.cu``) into a fresh
  control word, and one fetch of it.
"""

import numpy as np
import torch

from mythril_tpu_torch import obs
from mythril_tpu_torch.laser.cuda import _build, symtape, words
from mythril_tpu_torch.laser.cuda import keccak as keccak_mod
from mythril_tpu_torch.laser.cuda.batch import (
    ERROR,
    JD_RING,
    REVERTED,
    RETURNED,
    RUNNING,
    STOPPED,
    TRAP,
    TRAP_SS,
    CodeBank,
    StateBatch,
)
from mythril_tpu_torch.support.opcodes import OPCODES

EVM_STACK_LIMIT = 1024
SHA_CAP = 544  # 4 keccak blocks; longer inputs trap to the host
SHA_SYM_WORDS = 4  # max 32-byte words in a symbolic keccak preimage
I64 = torch.int64
M32 = 0xFFFFFFFF

_POPS = np.zeros(256, dtype=np.int64)
_PUSHES = np.zeros(256, dtype=np.int64)
_GAS = np.zeros(256, dtype=np.int64)
_GAS_MAX = np.zeros(256, dtype=np.int64)
_KNOWN = np.zeros(256, dtype=bool)
for _b, _spec in OPCODES.items():
    _KNOWN[_b] = True
    _POPS[_b] = _spec.pops
    _PUSHES[_b] = _spec.pushes
    _GAS[_b] = _spec.min_gas
    _GAS_MAX[_b] = _spec.max_gas
_GAS_MAX[0x20] = 30  # SHA3: the concrete 6/word goes to both counters

_TRAP_OPS = [0x3B, 0x3C, 0x3F, 0xF0, 0xF1, 0xF2, 0xF4, 0xF5, 0xFA, 0xFF]
_TRAP_TABLE = np.zeros(256, dtype=bool)
for _b in _TRAP_OPS:
    _TRAP_TABLE[_b] = True
_INVALID = ~_KNOWN.copy()
_INVALID[0xFE] = True

SENT = 1 << 28  # offset sentinel for operands that do not fit

launches = 0  # K1 launches (CUDA path only)
steps_run = 0  # the steps those launches were asked for (n_steps summed; a launch ends early once no lane runs)
stats_launches = 0  # those of the K1 launches that also folded the retired-opcode histogram
hist_launches = 0  # K8 launches (CUDA path only)
slice_launches = 0  # K9 launches (CUDA path only)


def _t(x, dev):
    return torch.as_tensor(x, device=dev)


def _argmax_first(m):
    """Index of the first True along the last axis (0 when none)."""
    return m.to(torch.int8).argmax(dim=-1)


def _argmin_first(m):
    """Index of the first False along the last axis (0 when none)."""
    return (~m).to(torch.int8).argmax(dim=-1)


def _ceil_div32(x):
    return torch.div(x + 31, 32, rounding_mode="floor")


def _mem_gas(old_words, new_words):
    c_new = 3 * new_words + torch.div(new_words * new_words, 512, rounding_mode="floor")
    c_old = 3 * old_words + torch.div(old_words * old_words, 512, rounding_mode="floor")
    return (c_new - c_old) & M32


def _signed_fix_div(q, a, b):
    flip = (words.sign_bit(a) == 1) ^ (words.sign_bit(b) == 1)
    return torch.where(flip[:, None], words.neg(q), q)


def _signed_fix_mod(r, a):
    return torch.where((words.sign_bit(a) == 1)[:, None], words.neg(r), r)


def _on_lanes(mask, fn, *args, width=words.NDIGITS):
    """fn(*args[mask]) scattered into zeros: the any-lane gate as a subset."""
    L = mask.shape[0]
    out = torch.zeros((L, width), dtype=I64, device=mask.device)
    if bool(mask.any()):
        out[mask] = fn(*(x[mask] for x in args))
    return out


def step_plain(cb: CodeBank, st: StateBatch, n_shards: int = 1) -> StateBatch:
    """Plain PyTorch twin of the reference ``step_impl`` (one step).

    ``n_shards`` > 1 is the step as each shard of the fused mesh tier
    runs it under ``shard_map`` (megakernel.py:360): every lane-local
    part is the same, and forks are placed inside each of the
    ``n_shards`` contiguous lane blocks (a block with no free lane left
    traps its forking parents with ``fork_no_slot``). The any-lane gates
    are per lane here already, so their scope does not matter."""
    D = words.NDIGITS
    dev = st.pc.device
    L = st.stack.shape[0]
    S = st.stack.shape[1] // D
    M = st.memory.shape[1]
    C = st.calldata.shape[1]
    K = st.storage_key.shape[1] // D
    CL = cb.code.shape[1]
    T = st.tape_op.shape[1]
    P = st.path_id.shape[1]
    lane = torch.arange(L, device=dev)
    W = words.from_plane

    stack3 = W(st.stack).view(L, S, D)
    skey3 = W(st.storage_key).view(L, K, D)
    sval3 = W(st.storage_val).view(L, K, D)
    pc = st.pc.to(I64)
    sp = st.sp.to(I64)
    code_id = st.code_id.to(I64)
    gas_left = W(st.gas_left)

    running = st.alive & (st.status == RUNNING)
    my_code_len = cb.code_len.to(I64)[code_id]
    pc_safe = pc.clamp(0, CL - 1)
    raw_op = cb.code[code_id, pc_safe].to(I64)
    past_end = pc >= my_code_len
    op = torch.where(past_end, 0, raw_op)

    pops = _t(_POPS, dev)[op]
    pushes = _t(_PUSHES, dev)[op]
    static_gas = _t(_GAS, dev)[op]
    static_gas_max = _t(_GAS_MAX, dev)[op]
    is_invalid = _t(_INVALID, dev)[op]
    is_trap_op = _t(_TRAP_TABLE, dev)[op]

    def peek(k):
        return stack3[lane, (sp - 1 - k).clamp(0, S - 1)]

    def peek_sym(k):
        idx = (sp - 1 - k).clamp(0, S - 1)
        return torch.where(sp > k, st.stack_sym[lane, idx].to(I64), 0)

    a, b, c = peek(0), peek(1), peek(2)
    sym_a, sym_b, sym_c = peek_sym(0), peek_sym(1), peek_sym(2)
    has_a, has_b, has_c = sym_a > 0, sym_b > 0, sym_c > 0

    underflow = sp < pops
    new_sp = sp - pops + pushes
    model_overflow = new_sp > S
    evm_overflow = new_sp > EVM_STACK_LIMIT
    ok_lane = running & ~underflow

    def off_view(w):
        u = words.to_u32(w)
        ok = words.fits_u32(w) & (u < SENT)
        return torch.where(ok, u, SENT), ok

    a32, a_fits = off_view(a)
    b32, b_fits = off_view(b)
    c32, c_fits = off_view(c)

    def opmask(*bs):
        m = torch.zeros(L, dtype=torch.bool, device=dev)
        for x in bs:
            m = m | (op == x)
        return m

    is_mload = opmask(0x51)
    is_mstore = opmask(0x52)
    is_mstore8 = opmask(0x53)
    is_sha3 = opmask(0x20)
    is_cdload = opmask(0x35)
    is_cdcopy = opmask(0x37)
    is_codecopy = opmask(0x39)
    is_retcopy = opmask(0x3E)
    is_return = opmask(0xF3)
    is_revert = opmask(0xFD)
    is_log = (op >= 0xA0) & (op <= 0xA4)

    zero = torch.zeros(L, dtype=I64, device=dev)
    m_off = zero
    m_len = zero
    off_fits = torch.ones(L, dtype=torch.bool, device=dev)
    for mask, off, ln, fits in (
        (is_mload | is_mstore, a32, torch.full_like(zero, 32), a_fits),
        (is_mstore8, a32, torch.full_like(zero, 1), a_fits),
        (is_sha3 | is_return | is_revert | is_log, a32, b32, a_fits & b_fits),
        (is_cdcopy | is_codecopy, a32, c32, a_fits & c_fits),
    ):
        m_off = torch.where(mask, off, m_off)
        m_len = torch.where(mask, ln, m_len)
        off_fits = torch.where(mask, fits, off_fits)
    touches = m_len > 0
    m_end = m_off + m_len
    mem_cap_trap = touches & (~off_fits | (m_end > M))
    mem_words = st.mem_words.to(I64)
    new_mem_words = torch.where(touches, torch.maximum(mem_words, _ceil_div32(m_end)), mem_words)
    gas_mem = torch.where(touches, _mem_gas(mem_words, new_mem_words), 0)
    retcopy_trap = is_retcopy & ((b32 > 0) | (c32 > 0))

    # ---- ALU (cheap families)
    def sel(res, mask, val):
        return torch.where(mask[:, None], val, res)

    res = torch.zeros((L, D), dtype=I64, device=dev)
    res = sel(res, opmask(0x01), words.add(a, b))
    res = sel(res, opmask(0x03), words.sub(a, b))
    res = sel(res, opmask(0x0B), words.signextend(a, b))
    res = sel(res, opmask(0x10), words.bool_to_word(words.ult(a, b)))
    res = sel(res, opmask(0x11), words.bool_to_word(words.ugt(a, b)))
    res = sel(res, opmask(0x12), words.bool_to_word(words.slt(a, b)))
    res = sel(res, opmask(0x13), words.bool_to_word(words.sgt(a, b)))
    res = sel(res, opmask(0x14), words.bool_to_word(words.eq(a, b)))
    res = sel(res, opmask(0x15), words.bool_to_word(words.is_zero(a)))
    res = sel(res, opmask(0x16), a & b)
    res = sel(res, opmask(0x17), a | b)
    res = sel(res, opmask(0x18), a ^ b)
    res = sel(res, opmask(0x19), words.bit_not(a))
    res = sel(res, opmask(0x1A), words.byte_word(a, b))
    res = sel(res, opmask(0x1B), words.shl(a, b))
    res = sel(res, opmask(0x1C), words.shr(a, b))
    res = sel(res, opmask(0x1D), words.sar(a, b))
    res = sel(res, opmask(0x02), words.mul(a, b))

    # division family (gated: 256-bit long division)
    div_mask = opmask(0x04, 0x05, 0x06, 0x07) & running
    signed = opmask(0x05, 0x07)
    aa, _an = words.abs_signed(a)
    bb, _bn = words.abs_signed(b)
    dividend = torch.where(signed[:, None], aa, a)
    divisor = torch.where(signed[:, None], bb, b)
    qr = _on_lanes(div_mask, lambda x, y: torch.cat(words.divmod256(x, y), -1), dividend, divisor, width=2 * D)
    q, r = qr[:, :D], qr[:, D:]
    res = sel(res, opmask(0x04), q)
    res = sel(res, opmask(0x06), r)
    res = sel(res, opmask(0x05), _signed_fix_div(q, a, b))
    res = sel(res, opmask(0x07), _signed_fix_mod(r, a))

    modal = opmask(0x08, 0x09)
    is_mulmod = opmask(0x09)

    def do_modal(x, y, n, ismul):
        s, carry = words.add_carry(x, y)
        wide_add = torch.cat([s, carry[:, None], torch.zeros_like(s[:, 1:])], -1)
        wide = torch.where(ismul[:, None], words.mul_full(x, y), wide_add)
        _q, rr = words._divmod_wide(wide, n, 512)
        return torch.where(words.is_zero(n)[:, None], 0, rr)

    res = sel(res, modal, _on_lanes(modal & running, do_modal, a, b, c, is_mulmod))
    is_exp = opmask(0x0A)
    res = sel(res, is_exp, _on_lanes(is_exp & running, words.exp, a, b))

    # ---- symbolic ALU node request
    alloc_meta = symtape.pack_meta(pc, st.path_len)
    sym_opt = _t(symtape.SYM_OP, dev).to(I64)[op]
    sym_ar = _t(symtape.SYM_ARITY, dev).to(I64)[op]
    alu_sym_mask = ok_lane & (sym_opt > 0) & (((sym_ar == 1) & has_a) | ((sym_ar == 2) & (has_a | has_b)))
    node_a = torch.where(has_a, sym_a, symtape.ARG_IMM)
    node_b = torch.where(sym_ar == 2, torch.where(has_b, sym_b, symtape.ARG_IMM), 0)
    both_or_unary = has_a & (has_b | (sym_ar == 1))
    imm_alu = torch.where(both_or_unary[:, None], 0, torch.where(has_a[:, None], b, a))

    # ---- environment pushes
    res = sel(res, opmask(0x30), W(st.address))
    res = sel(res, opmask(0x32), W(st.origin))
    res = sel(res, opmask(0x33), W(st.caller))
    res = sel(res, opmask(0x34), W(st.callvalue))
    res = sel(res, opmask(0x36), words.from_u32(st.calldata_len.to(I64)))
    res = sel(res, opmask(0x38), words.from_u32(my_code_len))
    res = sel(res, opmask(0x3D), torch.zeros_like(a))
    res = sel(res, opmask(0x47), W(st.balance))
    res = sel(res, opmask(0x58), words.from_u32(pc))
    res = sel(res, opmask(0x59), words.from_u32(mem_words * 32))
    gas_after_self = torch.where(gas_left >= 2, gas_left - 2, 0)
    res = sel(res, opmask(0x5A), words.from_u32(gas_after_self))

    is_balance = opmask(0x31)
    self_balance_hit = is_balance & ~has_a & words.eq(a, W(st.address))
    res = sel(res, self_balance_hit, W(st.balance))
    balance_trap = is_balance & ~self_balance_hit

    env_leaf_op = _t(symtape.ENV_LEAF_OP, dev).to(I64)[op]
    is_blockhash = opmask(0x40)
    env_leaf_mask = ok_lane & (env_leaf_op > 0)
    env_node_a = torch.where(is_blockhash, torch.where(has_a, sym_a, symtape.ARG_IMM), 0)
    env_imm = torch.where((is_blockhash & ~has_a)[:, None], a, 0)

    # ---- CALLDATALOAD / MLOAD gather
    g32 = torch.arange(32, device=dev)
    ld_mask = (is_mload | is_cdload) & running

    def do_ld(mem, cd, a32_, a_fits_, cdlen, iscd):
        src = torch.cat([mem, cd], dim=1).to(I64)
        n = src.shape[0]
        ld_off = torch.where(iscd, a32_ + M, a32_)
        idx = ld_off[:, None] + g32[None, :]
        cd_valid = ((a32_[:, None] + g32[None, :]) < cdlen[:, None]) & a_fits_[:, None]
        ml_valid = (a32_[:, None] + g32[None, :]) < M
        valid = torch.where(iscd[:, None], cd_valid, ml_valid)
        rows = torch.arange(n, device=dev)[:, None]
        return words.from_bytes_be(torch.where(valid, src[rows, idx.clamp(0, M + C - 1)], 0))

    ld_word = _on_lanes(ld_mask, do_ld, st.memory, st.calldata, a32, a_fits, st.calldata_len.to(I64), is_cdload)
    res = sel(res, is_cdload, ld_word)
    res = sel(res, is_mload, ld_word)

    cdload_sym_mask = ok_lane & is_cdload & st.calldata_symbolic
    cd_node_a = torch.where(has_a, sym_a, symtape.ARG_IMM)
    cd_imm = torch.where(has_a[:, None], 0, a)
    cdload_symoff_trap = is_cdload & has_a & ~st.calldata_symbolic

    # ---- symbolic memory overlay
    ent_used = st.msym_used
    ent_off = st.msym_off.to(I64)
    msym_id = st.msym_id.to(I64)
    e_ovl32 = ent_used & (ent_off < (a32 + 32)[:, None]) & ((ent_off + 32) > a32[:, None])
    e_exact = ent_used & (ent_off == a32[:, None])
    exact_any = e_exact.any(-1)
    exact_slot = _argmax_first(e_exact)
    partial_any = (e_ovl32 & ~e_exact).any(-1)
    mload_sym_hit = is_mload & ~has_a & exact_any
    mload_tag = torch.where(mload_sym_hit, msym_id[lane, exact_slot], 0)
    mload_ovl_trap = is_mload & ~has_a & partial_any
    val_sym_mstore = is_mstore & ~has_a & has_b
    ms_have_free = ~ent_used.all(-1)
    ms_free_slot = _argmin_first(ent_used)
    ms_slot = torch.where(exact_any, exact_slot, ms_free_slot)
    ms_ins_trap = val_sym_mstore & (partial_any | (~exact_any & ~ms_have_free))
    do_ms_sym = ok_lane & val_sym_mstore & ~ms_ins_trap
    mstore_conc = is_mstore & ~has_a & ~has_b
    mstore_conc_trap = mstore_conc & partial_any
    do_ms_clear = ok_lane & mstore_conc & exact_any
    e_ovl1 = ent_used & (ent_off <= a32[:, None]) & ((ent_off + 32) > a32[:, None])
    mstore8_ovl_trap = is_mstore8 & ~has_a & e_ovl1.any(-1)
    e_ovl_copy = ent_used & (ent_off < (a32 + c32)[:, None]) & ((ent_off + 32) > a32[:, None])
    copy_ovl_trap = (is_cdcopy | is_codecopy) & ~has_a & ~has_c & (c32 > 0) & e_ovl_copy.any(-1)

    new_msym_off = st.msym_off.clone()
    new_msym_id = st.msym_id.clone()
    new_msym_used = st.msym_used.clone()
    new_msym_off[lane, ms_slot] = torch.where(do_ms_sym, a32, ent_off[lane, ms_slot]).to(torch.int32)
    new_msym_id[lane, ms_slot] = torch.where(do_ms_sym, sym_b, msym_id[lane, ms_slot]).to(torch.int32)
    new_msym_used[lane, ms_slot] = new_msym_used[lane, ms_slot] | do_ms_sym
    new_msym_used[lane, exact_slot] = torch.where(do_ms_clear, False, new_msym_used[lane, exact_slot])

    # ---- PUSH
    is_push = (op >= 0x60) & (op <= 0x7F)
    k_push = torch.where(is_push, op - 0x5F, 0)
    res = sel(res, is_push, W(cb.push_imm[code_id, pc_safe]))
    res = sel(res, opmask(0x5F), torch.zeros_like(a))

    # ---- SLOAD / SSTORE
    is_sload = opmask(0x54)
    is_sstore = opmask(0x55)
    tape_op0 = st.tape_op.to(I64)
    tape_a0 = st.tape_a.to(I64)
    tape_b0 = st.tape_b.to(I64)
    imm3 = W(st.tape_imm).view(L, T, D)
    DL = symtape.DIGEST_LO
    DG = symtape.DIGEST_DIGITS
    probe_idx = (sym_a - 1).clamp(0, T - 1)
    probe_op = tape_op0[lane, probe_idx]
    probe_is_sha = probe_op == symtape.OP_SHA3
    sha_digest = imm3[lane, probe_idx][:, DL:]
    pa = tape_a0[lane, probe_idx]
    pb = tape_b0[lane, probe_idx]
    add_ref = torch.where(pa > 0, pa, pb)
    add_ref_idx = (add_ref - 1).clamp(0, T - 1)
    add_one_ref = ((pa > 0) & (pb == symtape.ARG_IMM)) | ((pb > 0) & (pa == symtape.ARG_IMM))
    add_imm = imm3[lane, probe_idx]
    add_off_small = (add_imm[:, DL:] == 0).all(-1)
    base_digest = imm3[lane, add_ref_idx][:, DL:]
    probe_is_addsha = (
        (probe_op == symtape.OP_ADD)
        & add_one_ref
        & (tape_op0[lane, add_ref_idx] == symtape.OP_SHA3)
        & add_off_small
        & (base_digest != 0).any(-1)
    )
    digest_sum, _ = words._ripple(base_digest + add_imm[:, :DG])
    probe_digest = torch.where(
        probe_is_addsha[:, None], digest_sum, torch.where(probe_is_sha[:, None], sha_digest, 0)
    )
    key_sha3_ok = ~has_a | probe_is_sha | probe_is_addsha
    sym_key_trap = (is_sload | is_sstore) & has_a & ~key_sha3_ok
    skey_sym = st.skey_sym.to(I64)
    sval_sym = st.sval_sym.to(I64)
    probe_has_digest = has_a & (probe_digest != 0).any(-1)
    digest_match = (
        (skey_sym > 0)
        & probe_has_digest[:, None]
        & (skey3[:, :, :DG] == probe_digest[:, None, :]).all(-1)
    )
    key_match = st.storage_used & torch.where(
        has_a[:, None],
        (skey_sym == sym_a[:, None]) | digest_match,
        (skey_sym == 0) & (skey3 == a[:, None, :]).all(-1),
    )
    found = key_match.any(-1)
    entry_big_conc = st.storage_used & (skey_sym == 0) & (skey3[:, :, 8:] != 0).any(-1)
    any_big_conc = entry_big_conc.any(-1)
    any_sym_entry = (st.storage_used & (skey_sym > 0)).any(-1)
    probe_big_conc = ~has_a & (a[:, 8:] != 0).any(-1)
    storage_alias_trap = (
        (is_sload | is_sstore) & ~found & ((has_a & any_big_conc) | (probe_big_conc & any_sym_entry))
    )
    sel_slot = _argmax_first(key_match)
    loaded = torch.where(found[:, None], sval3[lane, sel_slot], 0)
    loaded_sym = torch.where(found, sval_sym[lane, sel_slot], 0)
    res = sel(res, is_sload, loaded)
    sload_leaf_mask = ok_lane & is_sload & ~found & st.storage_symbolic & key_sha3_ok & ~storage_alias_trap
    skey_node_a = torch.where(has_a, sym_a, symtape.ARG_IMM)
    skey_imm = torch.where(has_a[:, None], 0, a)
    all_used = st.storage_used.all(-1)
    first_free = _argmin_first(st.storage_used)
    store_slot = torch.where(found, sel_slot, first_free)
    need_insert = (is_sstore | sload_leaf_mask) & ~found
    storage_trap = (need_insert & all_used) | storage_alias_trap
    do_store = ok_lane & (is_sstore | sload_leaf_mask) & ~storage_trap & ~sym_key_trap
    ev_sload = ok_lane & is_sload & ~storage_trap & ~sym_key_trap & ~storage_alias_trap
    ev_base = (ev_sload | (do_store & is_sstore)) & cb.record_storage_events
    const_key_mask = ev_base & ~has_a
    const_val_mask = ev_base & is_sstore & ~has_b

    # ---- combined tape allocation (group A, then CONST key, CONST value)
    tapes = {f: getattr(st, f).clone() for f in symtape.TAPE_FIELDS}
    ga_mask = alu_sym_mask | env_leaf_mask | cdload_sym_mask | sload_leaf_mask
    ga_op = torch.where(
        alu_sym_mask, sym_opt,
        torch.where(env_leaf_mask, env_leaf_op, torch.where(cdload_sym_mask, symtape.OP_CDLOAD, symtape.OP_SLOAD)),
    )
    ga_a = torch.where(
        alu_sym_mask, node_a, torch.where(env_leaf_mask, env_node_a, torch.where(cdload_sym_mask, cd_node_a, skey_node_a))
    )
    ga_b = torch.where(alu_sym_mask, node_b, 0)
    ga_imm = torch.where(
        alu_sym_mask[:, None], imm_alu,
        torch.where(env_leaf_mask[:, None], env_imm, torch.where(cdload_sym_mask[:, None], cd_imm, skey_imm)),
    )
    const_op = torch.full_like(zero, symtape.OP_CONST)
    const_arg = torch.full_like(zero, symtape.ARG_IMM)
    ga_id, ga_ok = symtape.alloc(tapes, ga_mask, ga_op, ga_a, ga_b, ga_imm, alloc_meta)
    key_const_id, kc_ok = symtape.alloc(tapes, const_key_mask, const_op, const_arg, zero, a, alloc_meta)
    val_const_id, vc_ok = symtape.alloc(tapes, const_val_mask, const_op, const_arg, zero, b, alloc_meta)
    group_alloc_ok = ga_ok & kc_ok & vc_ok
    alu_id = torch.where(alu_sym_mask, ga_id, 0)
    env_leaf_id = torch.where(env_leaf_mask, ga_id, 0)
    cdload_id = torch.where(cdload_sym_mask, ga_id, 0)
    sload_leaf_id = torch.where(sload_leaf_mask, ga_id, 0)

    sload_tag = torch.where(found, loaded_sym, torch.where(sload_leaf_mask, sload_leaf_id, 0))
    write_val = torch.where((is_sstore & ~has_b)[:, None], b, 0)
    write_val_sym = torch.where(is_sstore, sym_b, sload_leaf_id)
    write_key_sym = torch.where(has_a, sym_a, 0)
    digest_stamp = torch.zeros_like(a)
    digest_stamp[:, :DG] = probe_digest
    write_key = torch.where(has_a[:, None], digest_stamp, a)
    new_storage_key = skey3.clone()
    new_storage_val = sval3.clone()
    new_skey_sym = skey_sym.clone()
    new_sval_sym = sval_sym.clone()
    new_storage_used = st.storage_used.clone()
    new_storage_key[lane, store_slot] = torch.where(do_store[:, None], write_key, skey3[lane, store_slot])
    new_storage_val[lane, store_slot] = torch.where(do_store[:, None], write_val, sval3[lane, store_slot])
    new_skey_sym[lane, store_slot] = torch.where(do_store, write_key_sym, skey_sym[lane, store_slot])
    new_sval_sym[lane, store_slot] = torch.where(do_store, write_val_sym, sval_sym[lane, store_slot])
    new_storage_used[lane, store_slot] = st.storage_used[lane, store_slot] | do_store

    ev_key_id = torch.where(has_a, sym_a, key_const_id)
    ev_val_id = torch.where(is_sstore, torch.where(has_b, sym_b, val_const_id), 0)
    SSR = st.ss_pc.shape[1]
    ss_cnt = st.ss_cnt.to(I64)
    ss_full_trap = ev_base & (ss_cnt >= SSR)
    storage_event = ev_base & ~ss_full_trap
    ss_widx = ss_cnt.clamp(0, SSR - 1)

    def ss_put(plane, val):
        out = plane.clone()
        out[lane, ss_widx] = torch.where(storage_event, val.to(plane.dtype), plane[lane, ss_widx])
        return out

    new_ss_pc = ss_put(st.ss_pc, pc)
    new_ss_key = ss_put(st.ss_key, ev_key_id)
    new_ss_val = ss_put(st.ss_val, ev_val_id)
    new_ss_is_load = ss_put(st.ss_is_load, is_sload)
    new_ss_jd = ss_put(st.ss_jd, st.jd_cnt)
    new_ss_cnt = ss_cnt + storage_event.to(I64)

    # ---- SHA3 (concrete)
    sha_trap = is_sha3 & ~has_a & ~has_b & (b32 > SHA_CAP)
    sha_lanes = is_sha3 & running & ~sha_trap

    def do_sha(mem, a32_, b32_):
        sj = torch.arange(SHA_CAP, device=dev)
        sidx = a32_[:, None] + sj[None, :]
        rows = torch.arange(mem.shape[0], device=dev)[:, None]
        sbytes = torch.where(
            (sj[None, :] < b32_[:, None]) & (sidx < M), mem[rows, sidx.clamp(0, M - 1)].to(I64), 0
        ).to(torch.uint8)
        return words.from_bytes_be(keccak_mod.keccak256_plain(sbytes, torch.minimum(b32_, torch.tensor(SHA_CAP, device=dev))))

    res = sel(res, is_sha3, _on_lanes(sha_lanes, do_sha, st.memory, a32, b32))
    gas_sha = torch.where(is_sha3, 6 * _ceil_div32(b32), 0)

    # ---- SHA3 over symbolic overlay words: COMB chain + digest
    sha_end = a32 + b32
    e_rel = ent_off - a32[:, None]
    e_in = ent_used & (e_rel >= 0) & ((ent_off + 32) <= sha_end[:, None])
    e_aligned = (e_rel % 32) == 0
    e_ovl_sha = ent_used & (ent_off < sha_end[:, None]) & ((ent_off + 32) > a32[:, None])
    sha_any_sym = e_ovl_sha.any(-1)
    sha_sym_base = is_sha3 & ~has_a & ~has_b & ok_lane & sha_any_sym
    sha_bad = (e_ovl_sha & ~(e_in & e_aligned)).any(-1) | ((b32 % 32) != 0) | (b32 > 32 * SHA_SYM_WORDS)
    sha_sym_trap = sha_sym_base & sha_bad
    sha_sym_mask = sha_sym_base & ~sha_bad
    nwords = torch.div(b32, 32, rounding_mode="floor")
    sha_id = torch.zeros_like(zero)
    sha_ok = torch.ones(L, dtype=torch.bool, device=dev)
    if bool(sha_sym_mask.any()):
        tape_h1_0 = W(st.tape_h1)
        tape_h2_0 = W(st.tape_h2)
        rest = torch.zeros_like(zero)
        recs = [None] * SHA_SYM_WORDS
        for k in range(SHA_SYM_WORDS - 1, -1, -1):
            woff = a32 + 32 * k
            active = sha_sym_mask & (k < nwords)
            we = ent_used & (ent_off == woff[:, None])
            w_any = we.any(-1)
            w_id = msym_id[lane, _argmax_first(we)]
            widx = woff[:, None] + g32[None, :]
            wbytes = torch.where(widx < M, st.memory[lane[:, None], widx.clamp(0, M - 1)].to(I64), 0)
            wword = words.from_bytes_be(wbytes)
            comb_a = torch.where(w_any, w_id, symtape.ARG_IMM)
            comb_imm = torch.where(w_any[:, None], 0, wword)
            w_tape_idx = (w_id - 1).clamp(0, T - 1)
            h1 = torch.where(w_any, tape_h1_0[lane, w_tape_idx], 0)
            h2 = torch.where(w_any, tape_h2_0[lane, w_tape_idx], 0)
            hbytes = torch.stack(
                [(h1 >> 24) & 0xFF, (h1 >> 16) & 0xFF, (h1 >> 8) & 0xFF, h1 & 0xFF,
                 (h2 >> 24) & 0xFF, (h2 >> 16) & 0xFF, (h2 >> 8) & 0xFF, h2 & 0xFF], dim=-1,
            )
            body = torch.where(
                w_any[:, None], torch.cat([hbytes, torch.zeros((L, 24), dtype=I64, device=dev)], -1), wbytes
            )
            recs[k] = torch.cat([w_any[:, None].to(I64), body], -1)
            comb_id, comb_ok = symtape.alloc(
                tapes, active, torch.full_like(zero, symtape.OP_COMB), comb_a, rest, comb_imm, alloc_meta
            )
            rest = torch.where(active, comb_id, rest)
            sha_ok = sha_ok & comb_ok
        records = torch.cat(recs, -1).to(torch.uint8)
        d16 = keccak_mod.keccak256_plain(records, symtape.DIGEST_RECORD_BYTES * nwords)
        db = d16[:, :16].to(I64)
        sha_imm = words.from_u32(b32)
        sha_imm[:, DL:] = (db[:, 0::2] << 8) | db[:, 1::2]
        sha_id, sha3_ok = symtape.alloc(
            tapes, sha_sym_mask, torch.full_like(zero, symtape.OP_SHA3), rest, zero, sha_imm, alloc_meta
        )
        sha_ok = sha_ok & sha3_ok

    # ---- DUP / SWAP
    is_dup = (op >= 0x80) & (op <= 0x8F)
    dup_idx = (sp - (op - 0x7F)).clamp(0, S - 1)
    dup_val = stack3[lane, dup_idx]
    dup_tag = st.stack_sym[lane, dup_idx].to(I64)
    res = sel(res, is_dup, dup_val)
    is_swap = (op >= 0x90) & (op <= 0x9F)
    swap_lo_idx = (sp - 1 - (op - 0x8F)).clamp(0, S - 1)
    swap_hi_idx = (sp - 1).clamp(0, S - 1)

    # ---- control flow
    is_jump = opmask(0x56)
    is_jumpi = opmask(0x57)
    jump_dest_sym_trap = (is_jump | is_jumpi) & has_a
    cond_sym = is_jumpi & has_b & ~has_a
    dest32 = a32
    dest_ok = a_fits & (dest32 < my_code_len) & cb.jumpdest[code_id, dest32.clamp(0, CL - 1)]
    verdict = cb.jumpi_verdict[code_id, pc.clamp(0, CL - 1)].to(I64)
    must_take = cond_sym & (verdict == 1) & dest_ok
    must_fall = cond_sym & (verdict == 2)
    taken = ((is_jump | (is_jumpi & ~cond_sym & ~words.is_zero(b))) & ~has_a) | must_take
    jump_err = taken & ~dest_ok
    pc_next = pc + 1 + torch.where(is_push, k_push, 0)
    new_pc = torch.where(taken & dest_ok, dest32, pc_next)

    path_len = st.path_len.to(I64)
    path_ok = path_len < P
    path_append = ok_lane & cond_sym & path_ok
    path_full_trap = cond_sym & ~path_ok
    pwidx = path_len.clamp(0, P - 1)
    new_path_id = st.path_id.clone()
    new_path_sign = st.path_sign.clone()
    new_path_meta = st.path_meta.clone()
    new_path_id[lane, pwidx] = torch.where(path_append, sym_b, st.path_id[lane, pwidx].to(I64)).to(torch.int32)
    new_path_sign[lane, pwidx] = torch.where(path_append, must_take, st.path_sign[lane, pwidx])
    new_path_meta[lane, pwidx] = torch.where(
        path_append, words.to_plane(symtape.pack_meta(pc, path_len)), st.path_meta[lane, pwidx]
    )
    new_path_len = path_len + path_append.to(I64)

    fork_want = path_append & dest_ok & (gas_left >= static_gas) & ~must_take
    prune_child = (
        cb.prune_revert & st.outermost & cb.must_revert[code_id, dest32.clamp(0, CL - 1)]
    ) | must_fall
    fork_base = fork_want & ~prune_child
    free = ~st.alive
    # ranks inside each lane block (one block: the whole batch)
    per = L // n_shards
    base = (lane // per) * per
    nfree = free.to(I64).view(n_shards, per).sum(1).repeat_interleave(per)
    free_rank = (torch.cumsum(free.to(I64).view(n_shards, per), 1) - 1).reshape(L)
    req_rank = (torch.cumsum(fork_base.to(I64).view(n_shards, per), 1) - 1).reshape(L)
    has_slot = fork_base & (req_rank < nfree)
    fork_no_slot = fork_base & ~has_slot

    # ---- halts and status
    is_stop = opmask(0x00) | past_end
    rr_mask = (is_return | is_revert) & running
    new_ret_off = torch.where(rr_mask, a32, st.ret_off.to(I64))
    new_ret_len = torch.where(rr_mask, b32, st.ret_len.to(I64))

    alloc_trap = ~(group_alloc_ok & sha_ok)
    sym_trap_core = (
        jump_dest_sym_trap
        | (modal & (has_a | has_b | has_c))
        | ((is_mload | is_mstore | is_mstore8) & has_a)
        | (is_mstore8 & has_b)
        | (is_sha3 & (has_a | has_b))
        | ((is_return | is_revert | is_log) & (has_a | has_b))
        | ((is_cdcopy | is_codecopy | is_retcopy) & (has_a | has_b | has_c))
        | (is_cdcopy & st.calldata_symbolic & (c32 > 0))
        | cdload_symoff_trap
        | sym_key_trap
        | mload_ovl_trap
        | ms_ins_trap
        | mstore_conc_trap
        | mstore8_ovl_trap
        | copy_ovl_trap
        | sha_sym_trap
        | alloc_trap
        | path_full_trap
        | fork_no_slot
    )
    is_host_op = cb.host_ops[op]
    freeze = cb.freeze_errors
    err_cond = is_invalid | underflow | evm_overflow | jump_err
    trap_rest = (
        (
            is_trap_op | balance_trap | mem_cap_trap | retcopy_trap | storage_trap | sha_trap
            | sym_trap_core | is_host_op | (model_overflow & ~evm_overflow)
        )
        & ~is_invalid
        & ~underflow
    ) | (freeze & err_cond)
    trap = trap_rest | (ss_full_trap & ~is_invalid & ~underflow)
    hard_err = err_cond & ~freeze & ~trap
    ss_drain = ss_full_trap & trap & ~trap_rest

    total_gas = (static_gas + gas_mem + gas_sha) & M32
    charged = ~trap & ~hard_err
    oog = charged & (gas_left < total_gas)
    frozen_oog = freeze & oog
    new_gas = torch.where(charged & ~oog, gas_left - total_gas, torch.where(oog & ~freeze, 0, gas_left))
    total_gas_max = static_gas_max + gas_mem + gas_sha
    gas_max0 = W(st.gas_spent_max)
    new_gas_max = torch.where(charged & ~oog, (gas_max0 + total_gas_max) & M32, gas_max0)
    new_status = torch.where(
        hard_err | (oog & ~freeze),
        ERROR,
        torch.where(
            trap | frozen_oog,
            torch.where(ss_drain, TRAP_SS, TRAP),
            torch.where(is_stop, STOPPED, torch.where(is_return, RETURNED, torch.where(is_revert, REVERTED, RUNNING))),
        ),
    )
    committed = running & ~trap & ~hard_err & ~oog

    # ---- result tag
    res_sym = torch.zeros_like(zero)
    res_sym = torch.where(alu_sym_mask, alu_id, res_sym)
    res_sym = torch.where(cdload_sym_mask, cdload_id, res_sym)
    res_sym = torch.where(is_sload, sload_tag, res_sym)
    res_sym = torch.where(mload_sym_hit, mload_tag, res_sym)
    res_sym = torch.where(opmask(0x32), st.origin_sym.to(I64), res_sym)
    res_sym = torch.where(opmask(0x33), st.caller_sym.to(I64), res_sym)
    res_sym = torch.where(opmask(0x34), st.callvalue_sym.to(I64), res_sym)
    res_sym = torch.where(opmask(0x36), st.cdsize_sym.to(I64), res_sym)
    res_sym = torch.where(opmask(0x47), st.balance_sym.to(I64), res_sym)
    res_sym = torch.where(self_balance_hit, st.balance_sym.to(I64), res_sym)
    res_sym = torch.where(env_leaf_mask, env_leaf_id, res_sym)
    res_sym = torch.where(sha_sym_mask, sha_id, res_sym)
    res_sym = torch.where(is_dup, dup_tag, res_sym)

    # ---- stack writes (produced top, or the two SWAP slots)
    produces = (pushes > 0) & ~is_swap
    write_idx = (new_sp - 1).clamp(0, S - 1)
    swap_mask = committed & is_swap
    wr_mask = committed & produces
    lo_val = stack3[lane, swap_lo_idx]
    hi_val = stack3[lane, swap_hi_idx]
    lo_tag = st.stack_sym[lane, swap_lo_idx]
    hi_tag = st.stack_sym[lane, swap_hi_idx]
    stack_after = stack3.clone()
    stack_sym_after = st.stack_sym.clone()
    col0_val = torch.where(swap_mask[:, None], hi_val, res)
    col0_tag = torch.where(swap_mask, hi_tag.to(I64), res_sym)
    m0 = swap_mask | wr_mask
    idx0 = torch.where(swap_mask, swap_lo_idx, write_idx)
    stack_after[lane[m0], idx0[m0]] = col0_val[m0]
    stack_sym_after[lane[m0], idx0[m0]] = col0_tag[m0].to(torch.int32)
    stack_after[lane[swap_mask], swap_hi_idx[swap_mask]] = lo_val[swap_mask]
    stack_sym_after[lane[swap_mask], swap_hi_idx[swap_mask]] = lo_tag[swap_mask]

    # ---- memory writes
    mem = st.memory.clone()
    wmask = committed & is_mstore
    if bool(wmask.any()):
        b_bytes = torch.where(has_b[:, None], 0, words.to_bytes_be(b)).to(torch.uint8)
        pos = m_off[:, None] + g32[None, :]
        ok = wmask[:, None] & (pos < M)
        rows = lane[:, None].expand(L, 32)
        mem[rows[ok], pos[ok]] = b_bytes[ok]
    w8 = committed & is_mstore8 & (m_off < M)
    mem[lane[w8], m_off[w8]] = (b[w8, 0] & 0xFF).to(torch.uint8)
    midx = torch.arange(M, device=dev)[None, :]

    def copy_into(mem, wmask, src_rows, src_len, cap):
        if not bool(wmask.any()):
            return mem
        dst_rng = (midx >= a32[:, None]) & (midx < (a32 + c32)[:, None])
        src_idx = midx - a32[:, None] + b32[:, None]
        src_ok = (src_idx < src_len[:, None]) & b_fits[:, None] & (src_idx >= 0)
        gathered = torch.where(src_ok, torch.gather(src_rows, 1, src_idx.clamp(0, cap - 1)), 0)
        return torch.where(wmask[:, None] & dst_rng, gathered.to(torch.uint8), mem)

    mem = copy_into(mem, committed & is_cdcopy, st.calldata.to(I64), st.calldata_len.to(I64), C)
    mem = copy_into(mem, committed & is_codecopy, cb.code[code_id].to(I64), my_code_len, CL)

    # ---- commit
    def merge(new, old, mask=committed):
        m = mask.reshape(mask.shape + (1,) * (old.dim() - 1))
        return torch.where(m, new.to(old.dtype) if new.dtype != old.dtype else new, old)

    def merge32(new, old, mask=committed):
        """merge for planes holding u32 bits (int64 values in [0, 2^32))."""
        return merge(words.to_plane(new), old, mask)

    is_jmp = is_jump | is_jumpi
    visited = st.visited.clone()
    vpc = pc.clamp(0, CL - 1)
    visited[lane, vpc] = visited[lane, vpc] | committed
    jd_cnt = st.jd_cnt.to(I64)
    jd_ring = st.jd_ring.clone()
    ridx = jd_cnt % JD_RING
    jd_ring[lane, ridx] = torch.where(committed & is_jmp, new_pc, jd_ring[lane, ridx].to(I64)).to(torch.int32)
    i32 = torch.int32
    nst = dict(
        alive=st.alive,
        status=merge(new_status.to(i32), st.status, running),
        trap_op=merge(torch.where(trap | frozen_oog, op, st.trap_op.to(I64)).to(i32), st.trap_op, running),
        pc=merge(new_pc.to(i32), st.pc),
        code_id=st.code_id,
        stack=words.to_plane(stack_after.reshape(L, S * D)),
        sp=merge(new_sp.to(i32), st.sp),
        memory=merge(mem, st.memory),
        mem_words=merge(new_mem_words.to(i32), st.mem_words),
        gas_left=merge32(new_gas, st.gas_left, running),
        gas_spent_max=merge32(new_gas_max, st.gas_spent_max, running),
        storage_key=merge(words.to_plane(new_storage_key), st.storage_key.view(L, K, D)).reshape(L, K * D),
        storage_val=merge(words.to_plane(new_storage_val), st.storage_val.view(L, K, D)).reshape(L, K * D),
        storage_used=merge(new_storage_used, st.storage_used),
        ret_off=merge(new_ret_off.to(i32), st.ret_off, running),
        ret_len=merge(new_ret_len.to(i32), st.ret_len, running),
        calldata=st.calldata,
        calldata_len=st.calldata_len,
        callvalue=st.callvalue,
        caller=st.caller,
        origin=st.origin,
        address=st.address,
        balance=st.balance,
        steps=merge(st.steps + 1, st.steps),
        visited=visited,
        jd_ring=jd_ring,
        jd_cnt=(jd_cnt + (committed & is_jmp).to(I64)).to(i32),
        jump_cnt=(st.jump_cnt.to(I64) + (committed & is_jmp).to(I64)).to(i32),
        ss_pc=merge(new_ss_pc, st.ss_pc),
        ss_key=merge(new_ss_key, st.ss_key),
        ss_val=merge(new_ss_val, st.ss_val),
        ss_is_load=merge(new_ss_is_load, st.ss_is_load),
        ss_jd=merge(new_ss_jd, st.ss_jd),
        ss_cnt=merge(new_ss_cnt.to(i32), st.ss_cnt),
        spill_id=st.spill_id,
        stack_sym=stack_sym_after,
        tape_op=tapes["tape_op"],
        tape_a=tapes["tape_a"],
        tape_b=tapes["tape_b"],
        tape_imm=tapes["tape_imm"],
        tape_h1=tapes["tape_h1"],
        tape_h2=tapes["tape_h2"],
        tape_meta=tapes["tape_meta"],
        tape_len=merge(tapes["tape_len"], st.tape_len),
        path_id=merge(new_path_id, st.path_id),
        path_sign=merge(new_path_sign, st.path_sign),
        path_meta=merge(new_path_meta, st.path_meta),
        path_len=merge(new_path_len.to(i32), st.path_len),
        msym_off=merge(new_msym_off, st.msym_off),
        msym_id=merge(new_msym_id, st.msym_id),
        msym_used=merge(new_msym_used, st.msym_used),
        skey_sym=merge(new_skey_sym.to(i32), st.skey_sym),
        sval_sym=merge(new_sval_sym.to(i32), st.sval_sym),
        calldata_symbolic=st.calldata_symbolic,
        storage_symbolic=st.storage_symbolic,
        cdsize_sym=st.cdsize_sym,
        caller_sym=st.caller_sym,
        callvalue_sym=st.callvalue_sym,
        origin_sym=st.origin_sym,
        balance_sym=st.balance_sym,
        seed_id=st.seed_id,
        job_id=st.job_id,
        outermost=st.outermost,
        static_pruned=(
            st.static_pruned.to(I64)
            + (((fork_want & prune_child) | (must_take & path_append)) & committed).to(I64)
        ).to(i32),
    )

    # ---- JUMPI forks: each committed forking lane's post-step state is
    # copied into its ranked free lane, which takes the branch
    fork_do = has_slot & committed
    if not bool(fork_do.any()):
        return StateBatch(**nst)
    free_by_rank = torch.zeros(L, dtype=I64, device=dev)
    free_by_rank[base[free] + free_rank[free]] = lane[free]
    child_lane = free_by_rank[base + req_rank.clamp(0, per - 1)]
    src_map = lane.clone()
    src_map[child_lane[fork_do]] = lane[fork_do]
    child_mask = torch.zeros(L, dtype=torch.bool, device=dev)
    child_mask[child_lane[fork_do]] = True
    fst = {k: v[src_map] for k, v in nst.items()}
    dest_g = dest32[src_map]
    fst["pc"] = torch.where(child_mask, dest_g, fst["pc"].to(I64)).to(i32)
    plen_idx = (fst["path_len"].to(I64) - 1).clamp(0, P - 1)
    fst["path_sign"][lane[child_mask], plen_idx[child_mask]] = True
    ring_idx = (fst["jd_cnt"].to(I64) - 1) % JD_RING
    fst["jd_ring"][lane[child_mask], ring_idx[child_mask]] = dest_g[child_mask].to(i32)
    fst["static_pruned"] = torch.where(child_mask, 0, fst["static_pruned"])
    return StateBatch(**fst)


def step(cb: CodeBank, env, st: StateBatch, device="cuda", ctl=None, inplace=False, args=None,
         n_shards: int = 1, hist=None) -> StateBatch:
    """Advance every lane one instruction.

    On the CPU this is ``step_plain``. On the card it is one K1 launch
    of one step; with ``inplace`` the batch's own tensors are updated
    (the loops), otherwise a copy is stepped and returned. ``ctl`` is the
    loop's control word (the kernel returns at once once it says stop);
    ``args`` (kernels.StepArgs of this very batch, built with the same
    ``n_shards``) saves rebuilding the launch structs on every step of
    the loop. ``n_shards`` > 1 places forks per lane block (the fused
    mesh tier, see ``step_plain``). ``hist`` (int32[256] of u32 bits), if
    given, gets the step's retired opcodes added in place, as
    ``op_hist_update`` would add them."""
    return step_n(cb, env, st, 1, device=device, ctl=ctl, inplace=inplace, args=args, n_shards=n_shards,
                  hist=hist)


def step_n(cb: CodeBank, env, st: StateBatch, n_steps: int, device="cuda", ctl=None, inplace=False, args=None,
           n_shards: int = 1, hist=None) -> StateBatch:
    """Advance every lane ``n_steps`` instructions: ``step`` repeated, in
    one K1 launch on the card (the fused loops' round, the sync slice).
    On the CPU it is ``step_plain`` repeated while ``ctl`` (if given) says
    continue. With ``hist`` every step's retired opcodes are added into
    it in place: ``op_hist_update_plain`` after each step on the CPU, K1's
    stats instance on the card."""
    _build.check_on(device, st.pc, cb.code)
    if hist is not None:
        _build.check_on(device, hist)
    if st.pc.device.type == "cpu":
        if ctl is None or bool(ctl[1]):
            for _ in range(int(n_steps)):
                nst = step_plain(cb, st, n_shards)
                if hist is not None:
                    hist.copy_(op_hist_update_plain(cb, st, nst, hist))
                st = nst
        return st
    from mythril_tpu_torch.laser.cuda import kernels

    if not inplace:
        st = StateBatch(*(x.clone() for x in st))
        args = None
    if args is None:
        args = kernels.StepArgs(cb, st, n_shards)
    elif args.n_shards != n_shards:
        raise _build.KernelError(f"StepArgs built for {args.n_shards} shards, step asked for {n_shards}")
    global launches, steps_run, stats_launches
    launches += 1
    steps_run += int(n_steps)
    stats_launches += int(hist is not None)
    kernels.launch_step_run(args, n_steps, ctl, hist=hist)
    return st


# -- stats mode (B8) and the sync slice loop (B10) ----------------------


def op_hist_update_plain(cb: CodeBank, before, after, hist: torch.Tensor) -> torch.Tensor:
    """Twin of the reference's ``op_hist_update`` (engine.py:1398): the
    histogram ``hist`` (int32[256] holding u32 bits) plus one step.
    ``before`` needs ``code_id``, ``pc`` and ``steps``, ``after`` its
    ``steps``. A fork child's ``before`` is the free lane it landed in
    (stale code row and pc), and the child counts that lane's opcode, as
    in the reference. The code row is read as JAX's gather reads it: a
    negative id wraps once, then clamps."""
    n_codes, CL = cb.code.shape
    cid = before.code_id.to(I64)
    row = torch.where(cid < 0, cid + n_codes, cid).clamp(0, n_codes - 1)
    op = cb.code[row, before.pc.to(I64).clamp(0, CL - 1)].to(I64)
    idx = torch.where(after.steps > before.steps, op, 256)  # 256 = dropped
    counts = torch.bincount(idx, minlength=257)[:256]
    out = ((hist.to(I64) & M32) + counts) & M32
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def op_hist_update(cb: CodeBank, before, after, hist, device="cuda"):
    """Fold one step into the retired-opcode histogram.

    On the CPU this is ``op_hist_update_plain``. On the card it launches
    K8, which adds into ``hist`` in place and returns it. The port's loops
    do not call it: K1's stats instance folds the same bins inside its
    launch (``step_n(..., hist=)``)."""
    _build.check_on(device, after.steps, before.steps, cb.code, hist)
    if after.steps.device.type == "cpu":
        return op_hist_update_plain(cb, before, after, hist)
    from mythril_tpu_torch.laser.cuda import kernels

    global hist_launches
    hist_launches += 1
    kernels.launch_op_hist(kernels.HistArgs(cb, before, after, hist))
    return hist


def _any_running(st: StateBatch) -> bool:
    return bool((st.alive & (st.status == RUNNING)).any())


def slice_ctl_plain(st: StateBatch, ctl: torch.Tensor, max_steps: int) -> torch.Tensor:
    """Twin of K9: ``ctl = [t, continue, any_running, _]`` after the
    condition ``t < max_steps and any(alive & RUNNING)``, sticky once
    the loop has stopped."""
    running = int(_any_running(st))
    t = int(ctl[0])
    cont = int((t == 0 or bool(ctl[1])) and t < max_steps and bool(running))
    ctl[2], ctl[1], ctl[0] = running, cont, t + cont
    return ctl


def slice_ctl(st: StateBatch, ctl, max_steps: int, device="cuda") -> torch.Tensor:
    """Evaluate the slice loop's condition into ``ctl`` (K9 on the card)."""
    _build.check_on(device, st.alive, ctl)
    if st.alive.device.type == "cpu":
        return slice_ctl_plain(st, ctl, max_steps)
    from mythril_tpu_torch.laser.cuda import kernels

    global slice_launches
    slice_launches += 1
    kernels.launch_slice_ctl(kernels.SliceArgs(st, ctl, max_steps))
    return ctl


def any_running(st: StateBatch, device="cuda") -> bool:
    """The slice loop's quiescence read: is some lane alive and RUNNING?
    On the card, one K9 into a fresh control word and one fetch of it."""
    dev = _build.check_on(device, st.alive)
    if dev.type == "cpu":
        return _any_running(st)
    ctl = slice_ctl(st, torch.zeros(4, dtype=torch.int32, device=dev), 0, device=dev)
    with _build.sync_point():
        return bool(ctl[2].item())


def run_plain(cb: CodeBank, st: StateBatch, max_steps: int, with_stats: bool):
    """Twin of the reference's ``_run_impl``: the loop on the host, the
    condition evaluated before each step. Returns ``(state, hist)``;
    ``hist`` is int32[256] with stats, else int32[1] zeros."""
    hist = torch.zeros(256 if with_stats else 1, dtype=torch.int32, device=st.pc.device)
    t = 0
    s = st
    while t < max_steps and _any_running(s):
        ns = step_plain(cb, s)
        if with_stats:
            hist = op_hist_update_plain(cb, s, ns, hist)
        s = ns
        t += 1
    return s, hist


def _run_impl(cb: CodeBank, env, st: StateBatch, max_steps: int, with_stats: bool, device):
    dev = _build.check_on(device, st.pc, cb.code)
    if dev.type == "cpu":
        return run_plain(cb, st, max_steps, with_stats)
    # card: one K1 launch of max_steps steps on a copy; it leaves once no
    # lane is alive and RUNNING, the reference's loop condition, and with
    # stats folds every step it runs into the histogram
    s = StateBatch(*(x.clone() for x in st))
    hist = torch.zeros(256 if with_stats else 1, dtype=torch.int32, device=dev)
    step_n(cb, env, s, max_steps, device=dev, inplace=True, hist=hist if with_stats else None)
    return s, hist


def run(cb: CodeBank, env, st: StateBatch, max_steps: int = 4096, device="cuda") -> StateBatch:
    """Advance the batch until every lane halts/traps or max_steps."""
    with obs.TRACER.span("device_slice", tid="device", steps=max_steps):
        out, _hist = _run_impl(cb, env, st, max_steps, False, device)
    return out


def run_with_stats(cb: CodeBank, env, st: StateBatch, max_steps: int = 4096, device="cuda"):
    """:func:`run` plus the retired-opcode histogram (int32[256] of u32
    bits). Returns ``(state, hist)``."""
    with obs.TRACER.span("device_slice", tid="device", steps=max_steps):
        return _run_impl(cb, env, st, max_steps, True, device)
