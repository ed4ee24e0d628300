// K3 logic: the in-loop UNSAT screen (replaces
// mythril_tpu/laser/tpu/inloop_solve.py:123 unsat_mask), one warp per
// lane. Written as the parts of a warp's work split at its __syncwarp()s,
// each a function of the thread's lane in the warp (t, 0..31), so the
// host emulation runs them thread by thread, in either order. A lane's
// path entries, its pool assignment and the sweeps' forced flags live in
// the warp's slice of shared memory (UnsatWarp).
#pragma once
#include "common.cuh"

#define OP_ISZERO 32
#define PROP_SWEEPS 2
#define POOL_MAX_VARS 256

struct Pool {
  const uint32_t* var_h1;  // [V]
  const uint32_t* var_h2;  // [V]
  const int32_t* lit_var;  // [C, W]
  const uint8_t* lit_neg;  // [C, W]
  const uint8_t* lit_used; // [C, W]
  int V, C, W;
};

// One warp's shared memory: the lane's Pn path entries (a valid entry's
// tape node at clamp(id - 1, 0, T - 1): op, a, h1, h2) and the V-entry
// assignment with the sweep's forced-positive / forced-negative flags.
// Each array's place is computed from the base when it is used, so the
// warp keeps one pointer live, not ten.
struct UnsatWarp {
  uint8_t* base;
  int Pn, V;
  MT_DEVM int32_t* id() const { return (int32_t*)base; }
  MT_DEVM int32_t* op() const { return (int32_t*)base + Pn; }
  MT_DEVM int32_t* a() const { return (int32_t*)base + 2 * Pn; }
  MT_DEVM uint32_t* h1() const { return (uint32_t*)base + 3 * Pn; }
  MT_DEVM uint32_t* h2() const { return (uint32_t*)base + 4 * Pn; }
  MT_DEVM uint8_t* valid() const { return base + 20 * Pn; }
  MT_DEVM uint8_t* sign() const { return base + 21 * Pn; }
  MT_DEVM int8_t* assign() const { return (int8_t*)base + 22 * Pn; }
  MT_DEVM uint8_t* fp() const { return base + 22 * Pn + V; }
  MT_DEVM uint8_t* fn() const { return base + 22 * Pn + 2 * V; }
};

MT_HD int64_t unsat_warp_bytes(int Pn, int V) {
  return ((int64_t)Pn * 22 + (int64_t)V * 3 + 15) / 16 * 16;
}

// The block's copy of the pool in shared memory: var_h1, var_h2, lit_var,
// lit_neg, lit_used, then the warps' slices.
MT_HD int64_t unsat_pool_bytes(int V, int C, int W) {
  return ((int64_t)V * 8 + (int64_t)C * W * 6 + 15) / 16 * 16;
}

// part 0 (the block, before its barrier): thread tid of nthreads copies
// its share of the pool to base; the returned Pool points there.
MT_DEV Pool unsat_stage_pool(const Pool& g, uint8_t* base, int tid, int nthreads) {
  const int V = g.V, CW = g.C * g.W;
  uint32_t* h1 = (uint32_t*)base;
  uint32_t* h2 = h1 + V;
  int32_t* lv = (int32_t*)(h2 + V);
  uint8_t* ln = (uint8_t*)(lv + CW);
  uint8_t* lu = ln + CW;
  for (int i = tid; i < V; i += nthreads) {
    h1[i] = g.var_h1[i];
    h2[i] = g.var_h2[i];
  }
  for (int i = tid; i < CW; i += nthreads) {
    lv[i] = g.lit_var[i];
    ln[i] = g.lit_neg[i];
    lu[i] = g.lit_used[i];
  }
  Pool s = g;
  s.var_h1 = h1;
  s.var_h2 = h2;
  s.lit_var = lv;
  s.lit_neg = ln;
  s.lit_used = lu;
  return s;
}

MT_DEV UnsatWarp unsat_warp(uint8_t* base, int Pn, int V) {
  UnsatWarp w;
  w.base = base;
  w.Pn = Pn;
  w.V = V;
  return w;
}

// the reference reads assign[lit_var] with numpy-style indexing: a
// negative index wraps once, then the gather clamps
MT_DEV int gather_index(int v, int V) {
  if (v < 0) v += V;
  return v < 0 ? 0 : (v > V - 1 ? V - 1 : v);
}

// Only an alive RUNNING lane is screened (the same answer for the whole warp).
MT_DEV bool unsat_eligible(const Planes& P, int lane) {
  return PL(uint8_t, F_ALIVE)[lane] && PL(int32_t, F_STATUS)[lane] == RUNNING;
}

// part 1: stage path entries t, t + 32, ...
MT_DEV void unsat_stage(const Planes& P, int lane, const UnsatWarp& w, int t) {
  const int Pn = P.P, T = P.T;
  const int64_t ln = lane;
  const int plen = PL(int32_t, F_PATH_LEN)[lane];
  for (int i = t; i < Pn; i += 32) {
    const int id = PL(int32_t, F_PATH_ID)[ln * Pn + i];
    const bool ok = i < plen && id > 0;
    w.id()[i] = id;
    w.valid()[i] = ok;
    w.sign()[i] = PL(uint8_t, F_PATH_SIGN)[ln * Pn + i] ? 1 : 0;
    if (!ok) continue;
    int ti = id - 1;
    ti = ti > T - 1 ? T - 1 : ti;
    const int64_t k = ln * T + ti;
    w.op()[i] = PL(int32_t, F_TAPE_OP)[k];
    w.a()[i] = PL(int32_t, F_TAPE_A)[k];
    w.h1()[i] = PL(uint32_t, F_TAPE_H1)[k];
    w.h2()[i] = PL(uint32_t, F_TAPE_H2)[k];
  }
}

// part 2: R1 (same id, opposite signs) and R3 (u and ISZERO(u), same
// sign) for entries i = t, t + 32, ... against every entry j (i == j too)
MT_DEV bool unsat_r13(int Pn, const UnsatWarp& w, int t) {
  for (int i = t; i < Pn; i += 32) {
    if (!w.valid()[i]) continue;
    const bool is_isz = w.op()[i] == OP_ISZERO && w.a()[i] > 0;
    for (int j = 0; j < Pn; ++j) {
      if (!w.valid()[j]) continue;
      if (w.id()[i] == w.id()[j] && w.sign()[i] != w.sign()[j]) return true;
      if (is_isz && w.a()[i] == w.id()[j] && w.sign()[i] == w.sign()[j]) return true;
    }
  }
  return false;
}

// part 3: seed vars t, t + 32, ... from the path entries matched by their
// (h1, h2) identity hashes, and clear their forced flags
MT_DEV void unsat_seed(const Pool& pool, int Pn, const UnsatWarp& w, int t) {
  for (int v = t; v < pool.V; v += 32) {
    const uint32_t g1 = pool.var_h1[v], g2 = pool.var_h2[v];
    bool pos = false, neg = false;
    for (int i = 0; i < Pn; ++i) {
      if (!w.valid()[i] || w.h1()[i] != g1 || w.h2()[i] != g2) continue;
      if (w.sign()[i]) pos = true; else neg = true;
    }
    w.assign()[v] = (int8_t)((pos ? 1 : 0) - (neg ? 1 : 0));
    w.fp()[v] = 0;
    w.fn()[v] = 0;
  }
}

// part 4 (each sweep): clauses t, t + 32, ... against the assignment as it
// stood at the sweep's start (nothing writes it in this part); the one open
// literal of a unit clause is forced into fp / fn. Returns a conflict.
MT_DEV bool unsat_clauses(const Pool& pool, const UnsatWarp& w, int t) {
  const int V = pool.V, W = pool.W;
  bool conflict = false;
  for (int c = t; c < pool.C; c += 32) {
    int n_used = 0, n_true = 0, n_false = 0;
    for (int x = 0; x < W; ++x) {
      const int k = c * W + x;
      if (!pool.lit_used[k]) continue;
      ++n_used;
      const int lv = w.assign()[gather_index(pool.lit_var[k], V)];
      const bool ng = pool.lit_neg[k] != 0;
      if (ng ? lv < 0 : lv > 0) ++n_true;
      if (ng ? lv > 0 : lv < 0) ++n_false;
    }
    if (n_used == 0 || n_true != 0) continue;
    if (n_false == n_used) conflict = true;
    if (n_false != n_used - 1) continue;
    for (int x = 0; x < W; ++x) {  // folded by OR, not matmul
      const int k = c * W + x;
      if (!pool.lit_used[k]) continue;
      const int v = pool.lit_var[k];
      const int lv = w.assign()[gather_index(v, V)];
      const bool ng = pool.lit_neg[k] != 0;
      const bool tr = ng ? lv < 0 : lv > 0, fa = ng ? lv > 0 : lv < 0;
      if (tr || fa || v < 0 || v >= V) continue;
      if (ng) w.fn()[v] = 1; else w.fp()[v] = 1;  // every writer stores 1
    }
  }
  return conflict;
}

// part 5 (each sweep): vars t, t + 32, ... take their forced values (a
// var's owner is the only thread that reads or writes its entries here),
// and clear the flags for the next sweep. Returns a conflict.
MT_DEV bool unsat_apply(const Pool& pool, const UnsatWarp& w, int t) {
  bool conflict = false;
  for (int v = t; v < pool.V; v += 32) {
    const bool p = w.fp()[v], n = w.fn()[v];
    const int a = w.assign()[v];
    if ((p && a < 0) || (n && a > 0) || (p && n)) conflict = true;
    if (a == 0 && p) w.assign()[v] = 1;
    else if (a == 0 && n) w.assign()[v] = -1;
    w.fp()[v] = 0;
    w.fn()[v] = 0;
  }
  return conflict;
}
