// K1: one EVM instruction per lane (replaces mythril_tpu/laser/tpu/engine.py
// step_impl). Written per lane; see engine.py in the port for the launch
// structure (plan -> lane -> fork) and the reference for every rule.
#pragma once
#include "common.cuh"
#include "keccak.cuh"
#include "symtape.cuh"
#include "words.cuh"

#define EVM_STACK_LIMIT 1024
#define SHA_CAP 544
#define SHA_SYM_WORDS 4
#define SENT (1 << 28)
#define OP_SLOAD 5
#define OP_CDLOAD 3
#define OP_ADD 10
#define OP_COMB 33
#define OP_SHA3 34
#define OP_CONST 44
#define ARG_IMM (-1)
#define DIGEST_LO 8
#define DIGEST_DIGITS 8
#define DIGEST_RECORD_BYTES 33

// fork slot codes written by the plan pass
#define SLOT_NONE (-1)
#define SLOT_FULL (-2)

MT_DEV int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// i32 offset view of a word: value when it fits below 2^28, else SENT.
MT_DEV int off_view(const uint32_t* w, bool* ok) {
  uint32_t u = w_to_u32(w);
  *ok = w_fits_u32(w) && u < (uint32_t)SENT;
  return *ok ? (int)u : SENT;
}

MT_DEV uint32_t pack_meta(int pc, int path_len) {
  return ((uint32_t)pc & 0xFFFFu) | ((uint32_t)path_len << 16);
}

// The fork request of a lane (engine.py:964-1003), from the pre-step
// state alone: used by the plan pass to rank requests and by the lane
// pass, which must agree with it. Sets *dest to the jump target.
MT_DEV bool fork_base_of(const Planes& P, const Bank& B, const int32_t* tab, int lane, int* dest) {
  *dest = 0;
  if (!PL(uint8_t, F_ALIVE)[lane] || PL(int32_t, F_STATUS)[lane] != RUNNING) return false;
  const int S = P.S, CL = P.CL;
  int pc = PL(int32_t, F_PC)[lane], cid = PL(int32_t, F_CODE_ID)[lane];
  int sp = PL(int32_t, F_SP)[lane];
  int code_len = B.code_len[cid];
  if (pc >= code_len) return false;  // op = STOP
  int op = B.code[(int64_t)cid * CL + clampi(pc, 0, CL - 1)];
  if (op != 0x57) return false;
  if (sp < tab[TB_POPS * 256 + op]) return false;  // underflow: not ok_lane
  const int32_t* ssym = PL(int32_t, F_STACK_SYM) + (int64_t)lane * S;
  int sym_a = sp > 0 ? ssym[clampi(sp - 1, 0, S - 1)] : 0;
  int sym_b = sp > 1 ? ssym[clampi(sp - 2, 0, S - 1)] : 0;
  if (!(sym_b > 0 && sym_a <= 0)) return false;  // cond_sym
  if (PL(int32_t, F_PATH_LEN)[lane] >= P.P) return false;  // path_ok
  const uint32_t* a = PL(uint32_t, F_STACK) + ((int64_t)lane * S + clampi(sp - 1, 0, S - 1)) * ND;
  bool a_fits;
  int d = off_view(a, &a_fits);
  *dest = d;
  bool dest_ok = a_fits && d < code_len && B.jumpdest[(int64_t)cid * CL + clampi(d, 0, CL - 1)];
  if (!dest_ok) return false;
  int verdict = B.jumpi_verdict[(int64_t)cid * CL + clampi(pc, 0, CL - 1)];
  if (verdict == 1) return false;  // must_take jumps in place
  if (PL(uint32_t, F_GAS_LEFT)[lane] < (uint32_t)tab[TB_GAS * 256 + op]) return false;
  bool prune_child = (B.prune_revert[0] && PL(uint8_t, F_OUTERMOST)[lane] &&
                      B.must_revert[(int64_t)cid * CL + clampi(d, 0, CL - 1)]) ||
                     verdict == 2;
  return !prune_child;
}

// Plan, serial part (thread 0 of the one plan block): rank the free
// lanes and the requests; request r gets the r-th free lane if one
// exists (engine.py:1004-1009, 1327-1332).
MT_DEV void plan_assign(int L, const uint8_t* free_, const uint8_t* req, int32_t* slot,
                        int32_t* free_by_rank) {
  int nfree = 0;
  for (int l = 0; l < L; ++l) if (free_[l]) free_by_rank[nfree++] = l;
  int r = 0;
  for (int l = 0; l < L; ++l) {
    if (req[l]) { slot[l] = r < nfree ? free_by_rank[r] : SLOT_FULL; ++r; }
    else slot[l] = SLOT_NONE;
  }
}

// The concrete SHA3 request of a lane (engine.py:782-793): RUNNING lanes
// at SHA3 that do not trap on length hash min(b32, SHA_CAP) bytes of
// their memory from a32 on (bytes past the plane read as zero). The plan
// pass writes it per lane; K2 hashes the windows before the lane pass.
MT_DEV void sha_request(const Planes& P, const Bank& B, int lane, uint8_t* active, int32_t* off,
                        int32_t* avail, int32_t* len) {
  active[lane] = 0; off[lane] = 0; avail[lane] = 0; len[lane] = 0;
  if (!PL(uint8_t, F_ALIVE)[lane] || PL(int32_t, F_STATUS)[lane] != RUNNING) return;
  const int S = P.S, CL = P.CL;
  int pc = PL(int32_t, F_PC)[lane], cid = PL(int32_t, F_CODE_ID)[lane];
  if (pc >= B.code_len[cid] || B.code[(int64_t)cid * CL + clampi(pc, 0, CL - 1)] != 0x20) return;
  int sp = PL(int32_t, F_SP)[lane];
  const int32_t* ssym = PL(int32_t, F_STACK_SYM) + (int64_t)lane * S;
  bool has_a = sp > 0 && ssym[clampi(sp - 1, 0, S - 1)] > 0;
  bool has_b = sp > 1 && ssym[clampi(sp - 2, 0, S - 1)] > 0;
  const uint32_t* stk = PL(uint32_t, F_STACK) + (int64_t)lane * S * ND;
  bool a_fits, b_fits;
  int a32 = off_view(stk + clampi(sp - 1, 0, S - 1) * ND, &a_fits);
  int b32 = off_view(stk + clampi(sp - 2, 0, S - 1) * ND, &b_fits);
  if (!has_a && !has_b && b32 > SHA_CAP) return;  // sha_trap
  active[lane] = 1;
  off[lane] = a32 < P.M ? a32 : 0;
  avail[lane] = a32 < P.M ? P.M - a32 : 0;
  len[lane] = b32 < SHA_CAP ? b32 : SHA_CAP;
}

struct BufGet {
  const uint8_t* buf;
  MT_DEVM uint32_t operator()(int j) const { return buf[j]; }
};

// The per-lane step. Lanes that are not RUNNING are left untouched, as
// in the reference (every write there is gated on running or committed).
// fork_do[lane] / fork_dest[lane] tell the fork pass what to copy.
MT_DEV void step_lane(const Planes& P, const Bank& B, const int32_t* tab, const int32_t* slot,
                      const uint8_t* sha_digest, uint8_t* fork_do, int32_t* fork_dest, int lane) {
  fork_do[lane] = 0;
  if (!PL(uint8_t, F_ALIVE)[lane] || PL(int32_t, F_STATUS)[lane] != RUNNING) return;
  const int S = P.S, M = P.M, C = P.C, K = P.K, CL = P.CL, T = P.T, MS = P.MS;
  const int64_t ln = lane;

  int pc = PL(int32_t, F_PC)[lane];
  int cid = PL(int32_t, F_CODE_ID)[lane];
  int sp = PL(int32_t, F_SP)[lane];
  int code_len = B.code_len[cid];
  int pc_safe = clampi(pc, 0, CL - 1);
  bool past_end = pc >= code_len;
  int op = past_end ? 0 : B.code[(int64_t)cid * CL + pc_safe];

  int pops = tab[TB_POPS * 256 + op], pushes = tab[TB_PUSHES * 256 + op];
  uint32_t static_gas = (uint32_t)tab[TB_GAS * 256 + op];
  uint32_t static_gas_max = (uint32_t)tab[TB_GAS_MAX * 256 + op];
  bool is_invalid = tab[TB_INVALID * 256 + op] != 0;
  bool is_trap_op = tab[TB_TRAP * 256 + op] != 0;

  uint32_t* stk = PL(uint32_t, F_STACK) + ln * S * ND;
  int32_t* ssym = PL(int32_t, F_STACK_SYM) + ln * S;
  int ia = clampi(sp - 1, 0, S - 1), ib = clampi(sp - 2, 0, S - 1), ic = clampi(sp - 3, 0, S - 1);
  uint32_t a[ND], b[ND], c[ND];
  w_copy(a, stk + ia * ND); w_copy(b, stk + ib * ND); w_copy(c, stk + ic * ND);
  int sym_a = sp > 0 ? ssym[ia] : 0, sym_b = sp > 1 ? ssym[ib] : 0, sym_c = sp > 2 ? ssym[ic] : 0;
  bool has_a = sym_a > 0, has_b = sym_b > 0, has_c = sym_c > 0;

  bool underflow = sp < pops;
  int new_sp = sp - pops + pushes;
  bool model_overflow = new_sp > S;
  bool evm_overflow = new_sp > EVM_STACK_LIMIT;
  bool ok_lane = !underflow;

  bool a_fits, b_fits, c_fits;
  int a32 = off_view(a, &a_fits), b32 = off_view(b, &b_fits), c32 = off_view(c, &c_fits);

  bool is_mload = op == 0x51, is_mstore = op == 0x52, is_mstore8 = op == 0x53;
  bool is_sha3 = op == 0x20, is_cdload = op == 0x35, is_cdcopy = op == 0x37;
  bool is_codecopy = op == 0x39, is_retcopy = op == 0x3E, is_return = op == 0xF3;
  bool is_revert = op == 0xFD, is_log = op >= 0xA0 && op <= 0xA4;

  int m_off = 0, m_len = 0;
  bool off_fits = true;
  if (is_mload || is_mstore) { m_off = a32; m_len = 32; off_fits = a_fits; }
  else if (is_mstore8) { m_off = a32; m_len = 1; off_fits = a_fits; }
  else if (is_sha3 || is_return || is_revert || is_log) { m_off = a32; m_len = b32; off_fits = a_fits && b_fits; }
  else if (is_cdcopy || is_codecopy) { m_off = a32; m_len = c32; off_fits = a_fits && c_fits; }
  bool touches = m_len > 0;
  int64_t m_end = (int64_t)m_off + m_len;
  bool mem_cap_trap = touches && (!off_fits || m_end > M);
  int64_t mem_words = PL(int32_t, F_MEM_WORDS)[lane];
  int64_t new_mem_words = mem_words;
  uint32_t gas_mem = 0;
  if (touches) {
    int64_t need = (m_end + 31) / 32;
    new_mem_words = need > mem_words ? need : mem_words;
    int64_t cn = 3 * new_mem_words + (new_mem_words * new_mem_words) / 512;
    int64_t co = 3 * mem_words + (mem_words * mem_words) / 512;
    gas_mem = (uint32_t)(cn - co);
  }
  bool retcopy_trap = is_retcopy && (b32 > 0 || c32 > 0);

  // ---- ALU
  uint32_t res[ND];
  w_zero(res);
  switch (op) {
    case 0x01: w_add(res, a, b); break;
    case 0x02: w_mul(res, a, b); break;
    case 0x03: w_sub(res, a, b); break;
    case 0x04: case 0x06: {
      uint32_t q[ND], r[ND]; w_divmod(q, r, a, b);
      w_copy(res, op == 0x04 ? q : r); break;
    }
    case 0x05: case 0x07: {
      uint32_t aa[ND], bb[ND], q[ND], r[ND];
      w_abs(aa, a); w_abs(bb, b); w_divmod(q, r, aa, bb);
      if (op == 0x05) { if (w_sign(a) ^ w_sign(b)) w_neg(res, q); else w_copy(res, q); }
      else { if (w_sign(a)) w_neg(res, r); else w_copy(res, r); }
      break;
    }
    case 0x08: w_addmod(res, a, b, c); break;
    case 0x09: w_mulmod(res, a, b, c); break;
    case 0x0A: w_exp(res, a, b); break;
    case 0x0B: w_signextend(res, a, b); break;
    case 0x10: w_bool(res, w_ult(a, b)); break;
    case 0x11: w_bool(res, w_ult(b, a)); break;
    case 0x12: w_bool(res, w_slt(a, b)); break;
    case 0x13: w_bool(res, w_slt(b, a)); break;
    case 0x14: w_bool(res, w_eq(a, b)); break;
    case 0x15: w_bool(res, w_is_zero(a)); break;
    case 0x16: for (int i = 0; i < ND; ++i) res[i] = a[i] & b[i]; break;
    case 0x17: for (int i = 0; i < ND; ++i) res[i] = a[i] | b[i]; break;
    case 0x18: for (int i = 0; i < ND; ++i) res[i] = a[i] ^ b[i]; break;
    case 0x19: for (int i = 0; i < ND; ++i) res[i] = (~a[i]) & 0xFFFFu; break;
    case 0x1A: w_byte(res, a, b); break;
    case 0x1B: w_shl(res, a, b); break;
    case 0x1C: w_shr(res, a, b); break;
    case 0x1D: w_sar(res, a, b); break;
    default: break;
  }

  // ---- symbolic ALU node request
  int path_len = PL(int32_t, F_PATH_LEN)[lane];
  uint32_t alloc_meta = pack_meta(pc, path_len);
  int sym_opt = tab[TB_SYM_OP * 256 + op], sym_ar = tab[TB_SYM_ARITY * 256 + op];
  bool alu_sym_mask = ok_lane && sym_opt > 0 && ((sym_ar == 1 && has_a) || (sym_ar == 2 && (has_a || has_b)));
  int node_a = has_a ? sym_a : ARG_IMM;
  int node_b = sym_ar == 2 ? (has_b ? sym_b : ARG_IMM) : 0;
  bool both_or_unary = has_a && (has_b || sym_ar == 1);

  // ---- environment pushes
  const uint32_t* address = PL(uint32_t, F_ADDRESS) + ln * ND;
  const uint32_t* balance = PL(uint32_t, F_BALANCE) + ln * ND;
  uint32_t gas_left = PL(uint32_t, F_GAS_LEFT)[lane];
  switch (op) {
    case 0x30: w_copy(res, address); break;
    case 0x32: w_copy(res, PL(uint32_t, F_ORIGIN) + ln * ND); break;
    case 0x33: w_copy(res, PL(uint32_t, F_CALLER) + ln * ND); break;
    case 0x34: w_copy(res, PL(uint32_t, F_CALLVALUE) + ln * ND); break;
    case 0x36: w_from_u32(res, (uint32_t)PL(int32_t, F_CALLDATA_LEN)[lane]); break;
    case 0x38: w_from_u32(res, (uint32_t)code_len); break;
    case 0x3D: w_zero(res); break;
    case 0x47: w_copy(res, balance); break;
    case 0x58: w_from_u32(res, (uint32_t)pc); break;
    case 0x59: w_from_u32(res, (uint32_t)(mem_words * 32)); break;
    case 0x5A: w_from_u32(res, gas_left >= 2 ? gas_left - 2 : 0u); break;
    default: break;
  }
  bool is_balance = op == 0x31;
  bool self_balance_hit = is_balance && !has_a && w_eq(a, address);
  if (self_balance_hit) w_copy(res, balance);
  bool balance_trap = is_balance && !self_balance_hit;

  int env_leaf_op = tab[TB_ENV_LEAF * 256 + op];
  bool is_blockhash = op == 0x40;
  bool env_leaf_mask = ok_lane && env_leaf_op > 0;
  int env_node_a = is_blockhash ? (has_a ? sym_a : ARG_IMM) : 0;

  // ---- CALLDATALOAD / MLOAD
  uint8_t* mem = PL(uint8_t, F_MEMORY) + ln * M;
  const uint8_t* cd = PL(uint8_t, F_CALLDATA) + ln * C;
  int cdlen = PL(int32_t, F_CALLDATA_LEN)[lane];
  if (is_mload || is_cdload) {
    uint8_t by[32];
    for (int j = 0; j < 32; ++j) {
      int64_t i = (int64_t)a32 + j;
      bool valid = is_cdload ? (i < cdlen && a_fits) : (i < M);
      by[j] = valid ? (is_cdload ? cd[i] : mem[i]) : 0;
    }
    w_from_bytes_be(res, by);
  }
  bool calldata_symbolic = PL(uint8_t, F_CALLDATA_SYMBOLIC)[lane] != 0;
  bool cdload_sym_mask = ok_lane && is_cdload && calldata_symbolic;
  int cd_node_a = has_a ? sym_a : ARG_IMM;
  bool cdload_symoff_trap = is_cdload && has_a && !calldata_symbolic;

  // ---- symbolic memory overlay
  int32_t* msym_off = PL(int32_t, F_MSYM_OFF) + ln * MS;
  int32_t* msym_id = PL(int32_t, F_MSYM_ID) + ln * MS;
  uint8_t* msym_used = PL(uint8_t, F_MSYM_USED) + ln * MS;
  bool exact_any = false, partial_any = false, ovl1_any = false, ovl_copy_any = false;
  bool all_ent_used = true;
  int exact_slot = 0, ms_free_slot = -1;
  for (int e = 0; e < MS; ++e) {
    bool used = msym_used[e] != 0;
    int64_t off = msym_off[e];
    if (!used) { all_ent_used = false; if (ms_free_slot < 0) ms_free_slot = e; continue; }
    bool ovl32 = off < (int64_t)a32 + 32 && off + 32 > a32;
    bool exact = off == a32;
    if (exact && !exact_any) { exact_any = true; exact_slot = e; }
    if (ovl32 && !exact) partial_any = true;
    if (off <= a32 && off + 32 > a32) ovl1_any = true;
    if (off < (int64_t)a32 + c32 && off + 32 > a32) ovl_copy_any = true;
  }
  if (ms_free_slot < 0) ms_free_slot = 0;
  bool mload_sym_hit = is_mload && !has_a && exact_any;
  int mload_tag = mload_sym_hit ? msym_id[exact_slot] : 0;
  bool mload_ovl_trap = is_mload && !has_a && partial_any;
  bool val_sym_mstore = is_mstore && !has_a && has_b;
  int ms_slot = exact_any ? exact_slot : ms_free_slot;
  bool ms_ins_trap = val_sym_mstore && (partial_any || (!exact_any && all_ent_used));
  bool do_ms_sym = ok_lane && val_sym_mstore && !ms_ins_trap;
  bool mstore_conc = is_mstore && !has_a && !has_b;
  bool mstore_conc_trap = mstore_conc && partial_any;
  bool do_ms_clear = ok_lane && mstore_conc && exact_any;
  bool mstore8_ovl_trap = is_mstore8 && !has_a && ovl1_any;
  bool copy_ovl_trap = (is_cdcopy || is_codecopy) && !has_a && !has_c && c32 > 0 && ovl_copy_any;

  // ---- PUSH
  bool is_push = op >= 0x60 && op <= 0x7F;
  int k_push = is_push ? op - 0x5F : 0;
  if (is_push) w_copy(res, B.push_imm + ((int64_t)cid * CL + pc_safe) * ND);
  if (op == 0x5F) w_zero(res);

  // ---- SLOAD / SSTORE probe
  bool is_sload = op == 0x54, is_sstore = op == 0x55;
  const int32_t* t_op = PL(int32_t, F_TAPE_OP) + ln * T;
  const int32_t* t_a = PL(int32_t, F_TAPE_A) + ln * T;
  const int32_t* t_b = PL(int32_t, F_TAPE_B) + ln * T;
  const uint32_t* t_imm = PL(uint32_t, F_TAPE_IMM) + ln * T * ND;
  uint32_t* skey = PL(uint32_t, F_STORAGE_KEY) + ln * K * ND;
  uint32_t* sval = PL(uint32_t, F_STORAGE_VAL) + ln * K * ND;
  uint8_t* sused = PL(uint8_t, F_STORAGE_USED) + ln * K;
  int32_t* skey_sym = PL(int32_t, F_SKEY_SYM) + ln * K;
  int32_t* sval_sym = PL(int32_t, F_SVAL_SYM) + ln * K;
  int probe_idx = clampi(sym_a - 1, 0, T - 1);
  int probe_op = t_op[probe_idx];
  bool probe_is_sha = probe_op == OP_SHA3;
  int pa = t_a[probe_idx], pb = t_b[probe_idx];
  int add_ref = pa > 0 ? pa : pb;
  int add_ref_idx = clampi(add_ref - 1, 0, T - 1);
  bool add_one_ref = (pa > 0 && pb == ARG_IMM) || (pb > 0 && pa == ARG_IMM);
  const uint32_t* add_imm = t_imm + probe_idx * ND;
  const uint32_t* base_digest = t_imm + add_ref_idx * ND + DIGEST_LO;
  bool add_off_small = true, base_nz = false;
  for (int d = DIGEST_LO; d < ND; ++d) add_off_small = add_off_small && add_imm[d] == 0;
  for (int d = 0; d < DIGEST_DIGITS; ++d) base_nz = base_nz || base_digest[d] != 0;
  bool probe_is_addsha = probe_op == OP_ADD && add_one_ref && t_op[add_ref_idx] == OP_SHA3 &&
                         add_off_small && base_nz;
  uint32_t probe_digest[DIGEST_DIGITS];
  if (probe_is_addsha) {
    uint32_t carry = 0;
    for (int d = 0; d < DIGEST_DIGITS; ++d) {
      uint32_t s = base_digest[d] + add_imm[d] + carry;
      probe_digest[d] = s & 0xFFFFu; carry = s >> 16;
    }
  } else {
    for (int d = 0; d < DIGEST_DIGITS; ++d) probe_digest[d] = probe_is_sha ? add_imm[DIGEST_LO + d] : 0u;
  }
  bool key_sha3_ok = !has_a || probe_is_sha || probe_is_addsha;
  bool sym_key_trap = (is_sload || is_sstore) && has_a && !key_sha3_ok;
  bool probe_has_digest = false;
  for (int d = 0; d < DIGEST_DIGITS; ++d) probe_has_digest = probe_has_digest || probe_digest[d] != 0;
  probe_has_digest = probe_has_digest && has_a;
  bool found = false, any_big_conc = false, any_sym_entry = false, all_used = true;
  int sel_slot = 0, first_free = -1;
  for (int k = 0; k < K; ++k) {
    bool used = sused[k] != 0;
    if (!used) { all_used = false; if (first_free < 0) first_free = k; continue; }
    const uint32_t* kw = skey + k * ND;
    int ks = skey_sym[k];
    bool match;
    if (has_a) {
      bool dm = ks > 0 && probe_has_digest;
      for (int d = 0; d < DIGEST_DIGITS && dm; ++d) dm = kw[d] == probe_digest[d];
      match = ks == sym_a || dm;
    } else {
      match = ks == 0 && w_eq(kw, a);
    }
    if (match && !found) { found = true; sel_slot = k; }
    if (ks == 0) { for (int d = 8; d < ND; ++d) if (kw[d]) { any_big_conc = true; break; } }
    if (ks > 0) any_sym_entry = true;
  }
  if (first_free < 0) first_free = 0;
  bool probe_big_conc = false;
  if (!has_a) for (int d = 8; d < ND; ++d) probe_big_conc = probe_big_conc || a[d] != 0;
  bool storage_alias_trap = (is_sload || is_sstore) && !found &&
                            ((has_a && any_big_conc) || (probe_big_conc && any_sym_entry));
  int loaded_sym = found ? sval_sym[sel_slot] : 0;
  if (is_sload) { if (found) w_copy(res, sval + sel_slot * ND); else w_zero(res); }
  bool storage_symbolic = PL(uint8_t, F_STORAGE_SYMBOLIC)[lane] != 0;
  bool sload_leaf_mask = ok_lane && is_sload && !found && storage_symbolic && key_sha3_ok && !storage_alias_trap;
  int store_slot = found ? sel_slot : first_free;
  bool need_insert = (is_sstore || sload_leaf_mask) && !found;
  bool storage_trap = (need_insert && all_used) || storage_alias_trap;
  bool do_store = ok_lane && (is_sstore || sload_leaf_mask) && !storage_trap && !sym_key_trap;
  bool ev_sload = ok_lane && is_sload && !storage_trap && !sym_key_trap && !storage_alias_trap;
  bool ev_base = (ev_sload || (do_store && is_sstore)) && B.record_storage_events[0];
  bool const_key_mask = ev_base && !has_a;
  bool const_val_mask = ev_base && is_sstore && !has_b;

  // ---- combined tape allocation: group A, CONST key, CONST value
  int tlen = PL(int32_t, F_TAPE_LEN)[lane];
  bool ga_mask = alu_sym_mask || env_leaf_mask || cdload_sym_mask || sload_leaf_mask;
  int ga_op, ga_a, ga_b = alu_sym_mask ? node_b : 0;
  uint32_t ga_imm[ND];
  w_zero(ga_imm);
  if (alu_sym_mask) {
    ga_op = sym_opt; ga_a = node_a;
    if (!both_or_unary) w_copy(ga_imm, has_a ? b : a);
  } else if (env_leaf_mask) {
    ga_op = env_leaf_op; ga_a = env_node_a;
    if (is_blockhash && !has_a) w_copy(ga_imm, a);
  } else if (cdload_sym_mask) {
    ga_op = OP_CDLOAD; ga_a = cd_node_a;
    if (!has_a) w_copy(ga_imm, a);
  } else {
    ga_op = OP_SLOAD; ga_a = has_a ? sym_a : ARG_IMM;
    if (!has_a) w_copy(ga_imm, a);
  }
  int32_t ga_id, key_const_id, val_const_id;
  bool group_alloc_ok = tape_alloc(P, lane, &tlen, ga_mask, ga_op, ga_a, ga_b, ga_imm, alloc_meta, &ga_id);
  group_alloc_ok = tape_alloc(P, lane, &tlen, const_key_mask, OP_CONST, ARG_IMM, 0, a, alloc_meta, &key_const_id) && group_alloc_ok;
  group_alloc_ok = tape_alloc(P, lane, &tlen, const_val_mask, OP_CONST, ARG_IMM, 0, b, alloc_meta, &val_const_id) && group_alloc_ok;
  int alu_id = alu_sym_mask ? ga_id : 0;
  int env_leaf_id = env_leaf_mask ? ga_id : 0;
  int cdload_id = cdload_sym_mask ? ga_id : 0;
  int sload_leaf_id = sload_leaf_mask ? ga_id : 0;
  int sload_tag = found ? loaded_sym : (sload_leaf_mask ? sload_leaf_id : 0);
  int write_val_sym = is_sstore ? sym_b : sload_leaf_id;
  int write_key_sym = has_a ? sym_a : 0;

  int ev_key_id = has_a ? sym_a : key_const_id;
  int ev_val_id = is_sstore ? (has_b ? sym_b : val_const_id) : 0;
  const int SSR = P.SSR;
  int ss_cnt = PL(int32_t, F_SS_CNT)[lane];
  bool ss_full_trap = ev_base && ss_cnt >= SSR;
  bool storage_event = ev_base && !ss_full_trap;

  // ---- SHA3 (concrete): the digest K2 computed between the plan and
  // lane passes over this lane's memory window (see sha_request)
  bool sha_trap = is_sha3 && !has_a && !has_b && b32 > SHA_CAP;
  if (is_sha3) {
    w_zero(res);
    if (!sha_trap) {
      uint8_t dg[32];
      for (int j = 0; j < 32; ++j) dg[j] = sha_digest[ln * 32 + j];
      w_from_bytes_be(res, dg);
    }
  }
  uint32_t gas_sha = is_sha3 ? 6u * (uint32_t)(((int64_t)b32 + 31) / 32) : 0u;

  // ---- SHA3 over symbolic overlay words
  int64_t sha_end = (int64_t)a32 + b32;
  bool sha_any_sym = false, sha_bad_ent = false;
  for (int e = 0; e < MS; ++e) {
    if (!msym_used[e]) continue;
    int64_t off = msym_off[e];
    bool ovl = off < sha_end && off + 32 > a32;
    int64_t rel = off - a32;
    bool in = rel >= 0 && off + 32 <= sha_end;
    int64_t m = rel % 32; if (m < 0) m += 32;
    if (ovl) { sha_any_sym = true; if (!(in && m == 0)) sha_bad_ent = true; }
  }
  bool sha_sym_base = is_sha3 && !has_a && !has_b && ok_lane && sha_any_sym;
  bool sha_bad = sha_bad_ent || (b32 % 32) != 0 || b32 > 32 * SHA_SYM_WORDS;
  bool sha_sym_trap = sha_sym_base && sha_bad;
  bool sha_sym_mask = sha_sym_base && !sha_bad;
  int nwords = b32 / 32;
  int32_t sha_id = 0;
  bool sha_ok = true;
  if (sha_sym_mask) {
    // all records and chain operands from the pre-step planes first
    uint8_t rec[DIGEST_RECORD_BYTES * SHA_SYM_WORDS];
    int comb_a_k[SHA_SYM_WORDS];
    uint32_t comb_imm_k[SHA_SYM_WORDS][ND];
    const uint32_t* t_h1 = PL(uint32_t, F_TAPE_H1) + ln * T;
    const uint32_t* t_h2 = PL(uint32_t, F_TAPE_H2) + ln * T;
    for (int k = 0; k < SHA_SYM_WORDS; ++k) {
      int64_t woff = (int64_t)a32 + 32 * k;
      bool w_any = false; int w_slot = 0;
      for (int e = 0; e < MS; ++e)
        if (msym_used[e] && msym_off[e] == woff) { w_any = true; w_slot = e; break; }
      int w_id = msym_id[w_slot];
      uint8_t wb[32];
      for (int j = 0; j < 32; ++j) { int64_t i = woff + j; wb[j] = i < M ? mem[i] : 0; }
      uint8_t* r = rec + DIGEST_RECORD_BYTES * k;
      r[0] = w_any ? 1 : 0;
      if (w_any) {
        int wt = clampi(w_id - 1, 0, T - 1);
        uint32_t h1 = t_h1[wt], h2 = t_h2[wt];
        for (int j = 0; j < 4; ++j) { r[1 + j] = (uint8_t)(h1 >> (24 - 8 * j)); r[5 + j] = (uint8_t)(h2 >> (24 - 8 * j)); }
        for (int j = 9; j < DIGEST_RECORD_BYTES; ++j) r[j] = 0;
        comb_a_k[k] = w_id;
        w_zero(comb_imm_k[k]);
      } else {
        for (int j = 0; j < 32; ++j) r[1 + j] = wb[j];
        comb_a_k[k] = ARG_IMM;
        w_from_bytes_be(comb_imm_k[k], wb);
      }
    }
    int rest = 0;
    for (int k = SHA_SYM_WORDS - 1; k >= 0; --k) {
      bool active = k < nwords;
      int32_t cid1;
      sha_ok = tape_alloc(P, lane, &tlen, active, OP_COMB, comb_a_k[k], rest, comb_imm_k[k], alloc_meta, &cid1) && sha_ok;
      if (active) rest = cid1;
    }
    BufGet bg{rec};
    uint8_t d16[32];
    keccak256_padded(bg, DIGEST_RECORD_BYTES * nwords, 1, d16);
    uint32_t sha_imm[ND];
    w_from_u32(sha_imm, (uint32_t)b32);
    for (int d = 0; d < DIGEST_DIGITS; ++d) sha_imm[DIGEST_LO + d] = ((uint32_t)d16[2 * d] << 8) | d16[2 * d + 1];
    sha_ok = tape_alloc(P, lane, &tlen, true, OP_SHA3, rest, 0, sha_imm, alloc_meta, &sha_id) && sha_ok;
  }

  // ---- DUP / SWAP
  bool is_dup = op >= 0x80 && op <= 0x8F;
  int dup_idx = clampi(sp - (op - 0x7F), 0, S - 1);
  int dup_tag = ssym[dup_idx];
  if (is_dup) w_copy(res, stk + dup_idx * ND);
  bool is_swap = op >= 0x90 && op <= 0x9F;
  int swap_lo_idx = clampi(sp - 1 - (op - 0x8F), 0, S - 1);
  int swap_hi_idx = clampi(sp - 1, 0, S - 1);

  // ---- control flow
  bool is_jump = op == 0x56, is_jumpi = op == 0x57;
  bool jump_dest_sym_trap = (is_jump || is_jumpi) && has_a;
  bool cond_sym = is_jumpi && has_b && !has_a;
  int dest32 = a32;
  bool dest_ok = a_fits && dest32 < code_len && B.jumpdest[(int64_t)cid * CL + clampi(dest32, 0, CL - 1)];
  int verdict = B.jumpi_verdict[(int64_t)cid * CL + pc_safe];
  bool must_take = cond_sym && verdict == 1 && dest_ok;
  bool must_fall = cond_sym && verdict == 2;
  bool taken = ((is_jump || (is_jumpi && !cond_sym && !w_is_zero(b))) && !has_a) || must_take;
  bool jump_err = taken && !dest_ok;
  int pc_next = pc + 1 + (is_push ? k_push : 0);
  int new_pc = (taken && dest_ok) ? dest32 : pc_next;
  bool path_ok = path_len < P.P;
  bool path_append = ok_lane && cond_sym && path_ok;
  bool path_full_trap = cond_sym && !path_ok;
  bool fork_want = path_append && dest_ok && gas_left >= static_gas && !must_take;
  bool prune_child = (B.prune_revert[0] && PL(uint8_t, F_OUTERMOST)[lane] &&
                      B.must_revert[(int64_t)cid * CL + clampi(dest32, 0, CL - 1)]) || must_fall;
  bool fork_base = fork_want && !prune_child;
  bool has_slot = fork_base && slot[lane] >= 0;
  bool fork_no_slot = fork_base && !has_slot;

  // ---- status
  bool is_stop = op == 0x00 || past_end;
  bool alloc_trap = !(group_alloc_ok && sha_ok);
  bool sym_trap_core =
      jump_dest_sym_trap || ((op == 0x08 || op == 0x09) && (has_a || has_b || has_c)) ||
      ((is_mload || is_mstore || is_mstore8) && has_a) || (is_mstore8 && has_b) ||
      (is_sha3 && (has_a || has_b)) || ((is_return || is_revert || is_log) && (has_a || has_b)) ||
      ((is_cdcopy || is_codecopy || is_retcopy) && (has_a || has_b || has_c)) ||
      (is_cdcopy && calldata_symbolic && c32 > 0) || cdload_symoff_trap || sym_key_trap ||
      mload_ovl_trap || ms_ins_trap || mstore_conc_trap || mstore8_ovl_trap || copy_ovl_trap ||
      sha_sym_trap || alloc_trap || path_full_trap || fork_no_slot;
  bool is_host_op = B.host_ops[op] != 0;
  bool freeze = B.freeze_errors[0] != 0;
  bool err_cond = is_invalid || underflow || evm_overflow || jump_err;
  bool trap_rest = ((is_trap_op || balance_trap || mem_cap_trap || retcopy_trap || storage_trap ||
                     sha_trap || sym_trap_core || is_host_op || (model_overflow && !evm_overflow)) &&
                    !is_invalid && !underflow) ||
                   (freeze && err_cond);
  bool trap = trap_rest || (ss_full_trap && !is_invalid && !underflow);
  bool hard_err = err_cond && !freeze && !trap;
  bool ss_drain = ss_full_trap && trap && !trap_rest;
  uint32_t total_gas = static_gas + gas_mem + gas_sha;
  bool charged = !trap && !hard_err;
  bool oog = charged && gas_left < total_gas;
  bool frozen_oog = freeze && oog;
  uint32_t new_gas = (charged && !oog) ? gas_left - total_gas : ((oog && !freeze) ? 0u : gas_left);
  uint32_t gas_max0 = PL(uint32_t, F_GAS_SPENT_MAX)[lane];
  uint32_t new_gas_max = (charged && !oog) ? gas_max0 + static_gas_max + gas_mem + gas_sha : gas_max0;
  int new_status;
  if (hard_err || (oog && !freeze)) new_status = ERROR_;
  else if (trap || frozen_oog) new_status = ss_drain ? TRAP_SS : TRAP;
  else if (is_stop) new_status = STOPPED;
  else if (is_return) new_status = RETURNED;
  else if (is_revert) new_status = REVERTED;
  else new_status = RUNNING;
  bool committed = !trap && !hard_err && !oog;

  // running-lane bookkeeping (committed or not)
  PL(int32_t, F_STATUS)[lane] = new_status;
  if (trap || frozen_oog) PL(int32_t, F_TRAP_OP)[lane] = op;
  PL(uint32_t, F_GAS_LEFT)[lane] = new_gas;
  PL(uint32_t, F_GAS_SPENT_MAX)[lane] = new_gas_max;
  if (is_return || is_revert) { PL(int32_t, F_RET_OFF)[lane] = a32; PL(int32_t, F_RET_LEN)[lane] = b32; }
  if (!committed) return;

  // ---- result tag
  int res_sym = 0;
  if (alu_sym_mask) res_sym = alu_id;
  if (cdload_sym_mask) res_sym = cdload_id;
  if (is_sload) res_sym = sload_tag;
  if (mload_sym_hit) res_sym = mload_tag;
  if (op == 0x32) res_sym = PL(int32_t, F_ORIGIN_SYM)[lane];
  if (op == 0x33) res_sym = PL(int32_t, F_CALLER_SYM)[lane];
  if (op == 0x34) res_sym = PL(int32_t, F_CALLVALUE_SYM)[lane];
  if (op == 0x36) res_sym = PL(int32_t, F_CDSIZE_SYM)[lane];
  if (op == 0x47) res_sym = PL(int32_t, F_BALANCE_SYM)[lane];
  if (self_balance_hit) res_sym = PL(int32_t, F_BALANCE_SYM)[lane];
  if (env_leaf_mask) res_sym = env_leaf_id;
  if (sha_sym_mask) res_sym = sha_id;
  if (is_dup) res_sym = dup_tag;

  // ---- commit: stack
  if (is_swap) {
    uint32_t lo_val[ND], hi_val[ND];
    w_copy(lo_val, stk + swap_lo_idx * ND); w_copy(hi_val, stk + swap_hi_idx * ND);
    int lo_tag = ssym[swap_lo_idx], hi_tag = ssym[swap_hi_idx];
    w_copy(stk + swap_lo_idx * ND, hi_val); ssym[swap_lo_idx] = hi_tag;
    w_copy(stk + swap_hi_idx * ND, lo_val); ssym[swap_hi_idx] = lo_tag;
  } else if (pushes > 0) {
    int wi = clampi(new_sp - 1, 0, S - 1);
    w_copy(stk + wi * ND, res); ssym[wi] = res_sym;
  }
  PL(int32_t, F_SP)[lane] = new_sp;
  PL(int32_t, F_PC)[lane] = new_pc;

  // ---- memory
  if (is_mstore) {
    for (int j = 0; j < 32; ++j) {
      int i = m_off + j;
      if (i < M) mem[i] = has_b ? 0 : w_byte_be(b, j);
    }
  }
  if (is_mstore8 && m_off < M) mem[m_off] = (uint8_t)(b[0] & 0xFFu);
  if (is_cdcopy || is_codecopy) {
    const uint8_t* src = is_cdcopy ? cd : B.code + (int64_t)cid * CL;
    int64_t src_len = is_cdcopy ? cdlen : code_len;
    int cap = is_cdcopy ? C : CL;
    for (int64_t i = a32; i < (int64_t)a32 + c32 && i < M; ++i) {
      if (i < 0) continue;
      int64_t si = i - a32 + b32;
      bool ok = si < src_len && b_fits && si >= 0;
      mem[i] = ok ? src[si < 0 ? 0 : (si > cap - 1 ? cap - 1 : si)] : 0;
    }
  }
  PL(int32_t, F_MEM_WORDS)[lane] = (int32_t)new_mem_words;

  // ---- storage
  if (do_store) {
    uint32_t* kw = skey + store_slot * ND;
    if (has_a) { w_zero(kw); for (int d = 0; d < DIGEST_DIGITS; ++d) kw[d] = probe_digest[d]; }
    else w_copy(kw, a);
    uint32_t* vw = sval + store_slot * ND;
    if (is_sstore && !has_b) w_copy(vw, b); else w_zero(vw);
    skey_sym[store_slot] = write_key_sym;
    sval_sym[store_slot] = write_val_sym;
    sused[store_slot] = 1;
  }
  if (storage_event) {
    int w = clampi(ss_cnt, 0, SSR - 1);
    PL(int32_t, F_SS_PC)[ln * SSR + w] = pc;
    PL(int32_t, F_SS_KEY)[ln * SSR + w] = ev_key_id;
    PL(int32_t, F_SS_VAL)[ln * SSR + w] = ev_val_id;
    PL(uint8_t, F_SS_IS_LOAD)[ln * SSR + w] = is_sload ? 1 : 0;
    PL(int32_t, F_SS_JD)[ln * SSR + w] = PL(int32_t, F_JD_CNT)[lane];
    PL(int32_t, F_SS_CNT)[lane] = ss_cnt + 1;
  }

  // ---- counters, coverage, landing ring
  PL(int32_t, F_STEPS)[lane] += 1;
  PL(uint8_t, F_VISITED)[ln * CL + pc_safe] = 1;
  if (is_jump || is_jumpi) {
    int jd = PL(int32_t, F_JD_CNT)[lane];
    PL(int32_t, F_JD_RING)[ln * P.JD + (jd % P.JD)] = new_pc;
    PL(int32_t, F_JD_CNT)[lane] = jd + 1;
    PL(int32_t, F_JUMP_CNT)[lane] += 1;
  }
  PL(int32_t, F_TAPE_LEN)[lane] = tlen;

  // ---- path
  if (path_append) {
    int w = clampi(path_len, 0, P.P - 1);
    PL(int32_t, F_PATH_ID)[ln * P.P + w] = sym_b;
    PL(uint8_t, F_PATH_SIGN)[ln * P.P + w] = must_take ? 1 : 0;
    PL(uint32_t, F_PATH_META)[ln * P.P + w] = pack_meta(pc, path_len);
    PL(int32_t, F_PATH_LEN)[lane] = path_len + 1;
  }

  // ---- overlay
  if (do_ms_sym) { msym_off[ms_slot] = a32; msym_id[ms_slot] = sym_b; msym_used[ms_slot] = 1; }
  if (do_ms_clear) msym_used[exact_slot] = 0;

  if ((fork_want && prune_child) || (must_take && path_append)) PL(int32_t, F_STATIC_PRUNED)[lane] += 1;
  if (has_slot) { fork_do[lane] = 1; fork_dest[lane] = dest32; }
}

// The child's own edits after its planes were copied from the parent
// (engine.py:1346-1362).
MT_DEV void fork_child_edits(const Planes& P, int child, int dest) {
  const int64_t ln = child;
  PL(int32_t, F_PC)[child] = dest;
  int pl = clampi(PL(int32_t, F_PATH_LEN)[child] - 1, 0, P.P - 1);
  PL(uint8_t, F_PATH_SIGN)[ln * P.P + pl] = 1;
  int jd = PL(int32_t, F_JD_CNT)[child] - 1;
  int ri = ((jd % P.JD) + P.JD) % P.JD;
  PL(int32_t, F_JD_RING)[ln * P.JD + ri] = dest;
  PL(int32_t, F_STATIC_PRUNED)[child] = 0;
}
