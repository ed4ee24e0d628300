// Per-lane term tape: node hashing and the CSE-checked allocator
// (replaces mythril_tpu/laser/tpu/symtape.py:134 node_hash and :331
// _alloc_impl, inlined into K1).
#pragma once
#include "common.cuh"
#include "words.cuh"

MT_DEV uint32_t th_mix(uint32_t h, uint32_t v, uint32_t mul) {
  h = (h ^ v) * mul;
  return h ^ (h >> 16);
}

MT_DEV void node_hash(int32_t op, int32_t a, int32_t b, const uint32_t* imm, uint32_t* h1,
                      uint32_t* h2) {
  uint32_t x = th_mix((uint32_t)op + 0x811C9DC5u, (uint32_t)a, 0x9E3779B1u);
  x = th_mix(x, (uint32_t)b, 0x9E3779B1u);
  uint32_t y = th_mix((uint32_t)op + 0x01000193u, (uint32_t)a, 0x85EBCA77u);
  y = th_mix(y, (uint32_t)b, 0x85EBCA77u);
  for (int d = 0; d < ND; ++d) {
    x = th_mix(x, imm[d], 0x9E3779B1u);
    y = th_mix(y, imm[d], 0x85EBCA77u);
  }
  *h1 = x;
  *h2 = y;
}

// Append one node to `lane`'s tape unless an identical node exists.
// *tlen is the lane's running tape length (committed by the caller).
// CSE takes the FIRST row whose (h1, h2) match and verifies only that
// row, exactly as the reference's argmax does. Sets *id1 (1-based; 0
// when !mask) and returns ok (false when the tape is full).
MT_DEV bool tape_alloc(const Planes& P, int lane, int* tlen, bool mask, int32_t op, int32_t a,
                       int32_t b, const uint32_t* imm, uint32_t meta, int32_t* id1) {
  *id1 = 0;
  if (!mask) return true;
  const int T = P.T;
  int32_t* t_op = PL(int32_t, F_TAPE_OP) + (int64_t)lane * T;
  int32_t* t_a = PL(int32_t, F_TAPE_A) + (int64_t)lane * T;
  int32_t* t_b = PL(int32_t, F_TAPE_B) + (int64_t)lane * T;
  uint32_t* t_imm = PL(uint32_t, F_TAPE_IMM) + (int64_t)lane * T * ND;
  uint32_t* t_h1 = PL(uint32_t, F_TAPE_H1) + (int64_t)lane * T;
  uint32_t* t_h2 = PL(uint32_t, F_TAPE_H2) + (int64_t)lane * T;
  uint32_t* t_meta = PL(uint32_t, F_TAPE_META) + (int64_t)lane * T;
  uint32_t h1, h2;
  node_hash(op, a, b, imm, &h1, &h2);
  int n = *tlen;
  int cand = -1;
  for (int j = 0; j < n && j < T; ++j) {
    if (t_h1[j] == h1 && t_h2[j] == h2) { cand = j; break; }
  }
  bool hit = false;
  if (cand >= 0) {
    hit = t_op[cand] == op && t_a[cand] == a && t_b[cand] == b;
    for (int d = 0; d < ND && hit; ++d) hit = t_imm[cand * ND + d] == imm[d];
  }
  if (hit) { *id1 = cand + 1; return true; }
  bool overflow = n >= T;
  *id1 = n + 1;
  if (overflow) return false;
  t_op[n] = op; t_a[n] = a; t_b[n] = b; t_h1[n] = h1; t_h2[n] = h2; t_meta[n] = meta;
  for (int d = 0; d < ND; ++d) t_imm[n * ND + d] = imm[d];
  *tlen = n + 1;
  return true;
}
