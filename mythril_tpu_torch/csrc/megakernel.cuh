// K4 logic: the fused round's epilogue (replaces the tail of
// mythril_tpu/laser/tpu/megakernel.py:134 _one_round, with :113
// prune_mask and :121 compact_impl).
#pragma once
#include "common.cuh"

#define REVERT_OP 0xFD

// ctl = [r, continue, r_next, continue_next]: epi_plan stages the next
// control word in ctl[2..3]; epi_ctl commits it after the gather and
// copy-back of the same round have run under the current one.

MT_DEV bool dying_of(const Planes& P, const uint8_t* prune_revert, const uint8_t* unsat, int l,
                     bool* dead) {
  int st = PL(int32_t, F_STATUS)[l];
  bool at_revert = st == REVERTED || (st == TRAP && PL(int32_t, F_TRAP_OP)[l] == REVERT_OP);
  *dead = PL(uint8_t, F_ALIVE)[l] && PL(uint8_t, F_OUTERMOST)[l] && prune_revert[0] && at_revert;
  bool killed = unsat[l] && !*dead;
  return *dead || killed;
}

// Serial part of epi_plan (thread 0): the accumulator folds (int32,
// wrapping like the reference's i32 sums), the stable order (survivors
// first, each group in lane order) and the staged control word.
MT_DEV void epi_plan_serial(const Planes& P, const uint8_t* dead_s, const uint8_t* dying_s,
                            int32_t* acc, int32_t* order, uint8_t* dying_out, int32_t* ctl,
                            int max_rounds) {
  const int L = P.L;
  uint32_t pl = 0, uk = 0, ps = 0, px = 0;
  bool any_running = false;
  int n_alive = 0;
  for (int l = 0; l < L; ++l) {
    bool dy = dying_s[l];
    pl += dead_s[l];
    uk += dy && !dead_s[l];
    if (dy) {
      ps += (uint32_t)PL(int32_t, F_STEPS)[l];
      px += (uint32_t)PL(int32_t, F_STATIC_PRUNED)[l];
    }
    bool alive_after = PL(uint8_t, F_ALIVE)[l] && !dy;
    if (alive_after) {
      ++n_alive;
      if (PL(int32_t, F_STATUS)[l] == RUNNING) any_running = true;
    }
    dying_out[l] = dy;
  }
  acc[0] = (int32_t)((uint32_t)acc[0] + pl);
  acc[1] = (int32_t)((uint32_t)acc[1] + ps);
  acc[2] = (int32_t)((uint32_t)acc[2] + px);
  acc[3] = (int32_t)((uint32_t)acc[3] + uk);
  int front = 0, back = n_alive;
  for (int l = 0; l < L; ++l) {
    bool alive_after = PL(uint8_t, F_ALIVE)[l] && !dying_s[l];
    if (alive_after) order[front++] = l; else order[back++] = l;
  }
  int r_next = ctl[0] + 1;
  ctl[2] = r_next;
  ctl[3] = (r_next < max_rounds && any_running) ? 1 : 0;
}

// One destination lane of the compaction, after its rows were copied
// from order[dst_lane]: the dying source's folds and zeroing.
MT_DEV void epi_fold_lane(const Planes& src, const Planes& dst, const int32_t* order,
                          const uint8_t* dying, uint8_t* pv, int dst_lane, int tid,
                          int nthreads) {
  int s = order[dst_lane];
  if (!dying[s]) return;
  const int CL = src.CL;
  const uint8_t* vis = (const uint8_t*)src.p[F_VISITED] + (int64_t)s * CL;
  uint8_t* pvr = pv + (int64_t)((const int32_t*)src.p[F_CODE_ID])[s] * CL;
  uint8_t* dvis = (uint8_t*)dst.p[F_VISITED] + (int64_t)dst_lane * CL;
  for (int j = tid; j < CL; j += nthreads) {
    if (vis[j]) pvr[j] = 1;  // every writer stores 1: a benign race
    dvis[j] = 0;
  }
  if (tid == 0) {
    ((uint8_t*)dst.p[F_ALIVE])[dst_lane] = 0;
    ((int32_t*)dst.p[F_STEPS])[dst_lane] = 0;
    ((int32_t*)dst.p[F_STATIC_PRUNED])[dst_lane] = 0;
  }
}
