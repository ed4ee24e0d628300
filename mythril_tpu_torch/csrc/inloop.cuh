// K3 per-lane logic: the in-loop UNSAT screen (replaces
// mythril_tpu/laser/tpu/inloop_solve.py:123 unsat_mask).
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

// the reference reads assign[lit_var] with numpy-style indexing: a
// negative index wraps once, then the gather clamps
MT_DEV int gather_index(int v, int V) {
  if (v < 0) v += V;
  return v < 0 ? 0 : (v > V - 1 ? V - 1 : v);
}

MT_DEV bool unsat_lane(const Planes& P, const Pool& pool, int lane) {
  if (!PL(uint8_t, F_ALIVE)[lane] || PL(int32_t, F_STATUS)[lane] != RUNNING) return false;
  const int Pn = P.P, T = P.T;
  const int64_t ln = lane;
  const int32_t* ids = PL(int32_t, F_PATH_ID) + ln * Pn;
  const uint8_t* sign = PL(uint8_t, F_PATH_SIGN) + ln * Pn;
  const int32_t* t_op = PL(int32_t, F_TAPE_OP) + ln * T;
  const int32_t* t_a = PL(int32_t, F_TAPE_A) + ln * T;
  const uint32_t* t_h1 = PL(uint32_t, F_TAPE_H1) + ln * T;
  const uint32_t* t_h2 = PL(uint32_t, F_TAPE_H2) + ln * T;
  int plen = PL(int32_t, F_PATH_LEN)[lane];

  // R1 (same id, opposite signs) and R3 (u and ISZERO(u), same sign)
  for (int i = 0; i < Pn; ++i) {
    if (!(i < plen && ids[i] > 0)) continue;
    int ti = ids[i] - 1; ti = ti < 0 ? 0 : (ti > T - 1 ? T - 1 : ti);
    bool is_isz = t_op[ti] == OP_ISZERO && t_a[ti] > 0;
    for (int j = 0; j < Pn; ++j) {
      if (!(j < plen && ids[j] > 0)) continue;
      if (ids[i] == ids[j] && sign[i] != sign[j]) return true;
      if (is_isz && t_a[ti] == ids[j] && sign[i] == sign[j]) return true;
    }
  }

  // clause pool: seed the assignment from the path
  const int V = pool.V, C = pool.C, W = pool.W;
  int8_t assign[POOL_MAX_VARS];
  for (int v = 0; v < V; ++v) {
    bool pos = false, neg = false;
    for (int i = 0; i < Pn; ++i) {
      if (!(i < plen && ids[i] > 0)) continue;
      int ti = ids[i] - 1; ti = ti < 0 ? 0 : (ti > T - 1 ? T - 1 : ti);
      if (t_h1[ti] == pool.var_h1[v] && t_h2[ti] == pool.var_h2[v]) {
        if (sign[i]) pos = true; else neg = true;
      }
    }
    assign[v] = (int8_t)((pos ? 1 : 0) - (neg ? 1 : 0));
  }
  bool conflict = false;
  for (int sweep = 0; sweep < PROP_SWEEPS; ++sweep) {
    uint8_t fp[POOL_MAX_VARS], fn[POOL_MAX_VARS];
    for (int v = 0; v < V; ++v) { fp[v] = 0; fn[v] = 0; }
    for (int c = 0; c < C; ++c) {
      int n_used = 0, n_true = 0, n_false = 0;
      for (int w = 0; w < W; ++w) {
        int k = c * W + w;
        if (!pool.lit_used[k]) continue;
        ++n_used;
        int lv = assign[gather_index(pool.lit_var[k], V)];
        bool ng = pool.lit_neg[k] != 0;
        if (ng ? lv < 0 : lv > 0) ++n_true;
        if (ng ? lv > 0 : lv < 0) ++n_false;
      }
      if (n_used == 0 || n_true != 0) continue;
      if (n_false == n_used) conflict = true;
      if (n_false == n_used - 1) {
        // the one open literal is forced true (folded by OR, not matmul)
        for (int w = 0; w < W; ++w) {
          int k = c * W + w;
          if (!pool.lit_used[k]) continue;
          int v = pool.lit_var[k];
          int lv = assign[gather_index(v, V)];
          bool ng = pool.lit_neg[k] != 0;
          bool t = ng ? lv < 0 : lv > 0, f = ng ? lv > 0 : lv < 0;
          if (t || f || v < 0 || v >= V) continue;
          if (ng) fn[v] = 1; else fp[v] = 1;
        }
      }
    }
    for (int v = 0; v < V; ++v) {
      if ((fp[v] && assign[v] < 0) || (fn[v] && assign[v] > 0) || (fp[v] && fn[v])) conflict = true;
      if (fp[v] && assign[v] == 0) assign[v] = 1;
      if (fn[v] && assign[v] == 0) assign[v] = -1;
    }
  }
  return conflict;
}
