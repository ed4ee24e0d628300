// K4 logic: the fused round's epilogue (replaces the tail of
// mythril_tpu/laser/tpu/megakernel.py:134 _one_round, with :113
// prune_mask and :121 compact_impl). Written as the parts of one
// cooperative launch (megakernel.cu) split at its barriers, each a
// function of the thread's place in the grid, so the host emulation runs
// them thread by thread, in either order.
#pragma once
#include "common.cuh"
#include "scan.cuh"

#define REVERT_OP 0xFD
#define EPI_MAX_LANES RANK_MAX_LANES
#define EPI_MAX_WARPS 32

// ctl = [r, continue, r_next, continue_next]: the plan stages the next
// control word in ctl[2..3]; block 0 commits it after the gather and
// copy-back of the same round have run under the current one. The fused
// mesh tier commits only after the round's work-steal (K10/K11) and its
// compaction, which run under the same word: the reference's loop body
// is round + steal, and the condition is tested after both.

// epilogue flags: commit the staged control word; compaction only (no
// prune, kill, folds or staging: the compaction after a steal)
#define EPI_COMMIT 1
#define EPI_COMPACT_ONLY 2

// a lane's plan flags; bits 0-2 are the ones the scan counts
#define EF_SURVIVES 1  // alive after the round
#define EF_DIES 2      // REVERT-pruned or killed in the loop
#define EF_RUNS 4      // alive after the round and RUNNING
#define EF_DEAD 8      // REVERT-pruned

// the planes a dying lane has zeroed (megakernel.py:182-186)
#define EPI_ZEROED ((1ull << F_ALIVE) | (1ull << F_STEPS) | (1ull << F_STATIC_PRUNED) | (1ull << F_VISITED))
#define ALL_FIELDS (~(uint64_t)0)

#define EPI_BATCH 4  // units a thread loads before it stores any

// one block's shared memory
struct EpiShared {
  RankShared rs;                    // the scan of every lane's flags
  int32_t src_of[EPI_MAX_LANES];    // destination lane -> source lane
  uint32_t fold[EPI_MAX_WARPS][4];  // per warp: its share of the folds
  // A lane's row of every plane as one list of units: plane f's row is
  // units ustart[f] .. ustart[f + 1] - 1, each 1 << ushift[f] bytes (16,
  // 4 or 1: the widest its row size and both batches' bases allow).
  uint8_t* base[2][NFIELDS];  // plane bases: [0] the state, [1] scratch
  int64_t rb[NFIELDS];
  int32_t ustart[NFIELDS + 1];
  uint8_t ushift[NFIELDS];
};

MT_DEV uint8_t epi_lane_flags(const Planes& P, const uint8_t* prune_revert, const uint8_t* unsat, int l,
                              bool compact_only) {
  uint8_t f = 0;
  const bool alive = PL(uint8_t, F_ALIVE)[l];
  const int st = PL(int32_t, F_STATUS)[l];
  if (!compact_only) {
    bool at_revert = st == REVERTED || (st == TRAP && PL(int32_t, F_TRAP_OP)[l] == REVERT_OP);
    bool dead = alive && PL(uint8_t, F_OUTERMOST)[l] && prune_revert[0] && at_revert;
    if (dead) f = EF_DEAD | EF_DIES;
    else if (unsat[l]) f = EF_DIES;
  }
  if (alive && !(f & EF_DIES)) f |= st == RUNNING ? EF_SURVIVES | EF_RUNS : EF_SURVIVES;
  return f;
}

// part 1 (grid-wide, before the first barrier): every lane's flags and
// dying mask, and this thread's share of the folds [pruned lanes, pruned
// steps, pruned static, in-loop kills] as u32 sums (the reference's i32
// sums wrap the same way, and integer addition does not care about order).
MT_DEV void epi_plan_lanes(const Planes& P, const uint8_t* prune_revert, const uint8_t* unsat,
                           uint8_t* lflags, uint8_t* dying, bool compact_only, int gtid, int gthreads,
                           uint32_t fold[4]) {
  fold[0] = fold[1] = fold[2] = fold[3] = 0;
  for (int l = gtid; l < P.L; l += gthreads) {
    uint8_t f = epi_lane_flags(P, prune_revert, unsat, l, compact_only);
    lflags[l] = f;
    dying[l] = (f & EF_DIES) ? 1 : 0;
    if (f & EF_DIES) {
      fold[0] += (f & EF_DEAD) ? 1u : 0u;  // constant indices: the sums stay in registers
      fold[3] += (f & EF_DEAD) ? 0u : 1u;
      fold[1] += (uint32_t)PL(int32_t, F_STEPS)[l];
      fold[2] += (uint32_t)PL(int32_t, F_STATIC_PRUNED)[l];
    }
  }
}

// part 2, after the block's scan of lflags (scan.cuh): a lane's place in
// the stable order of its contiguous block of per lanes, survivors first
// (compact_impl; per shard under shard_map, megakernel.py:378)
MT_DEV int epi_dest(const RankShared& rs, int per, uint8_t f, int l) {
  const int base = l / per * per;
  const int before = lf_n0(rs.pre[l]) - lf_n0(rs.pre[base]);
  if (f & EF_SURVIVES) return base + before;
  return base + lf_n0(rs.pre[base + per]) - lf_n0(rs.pre[base]) + (l - base - before);
}

MT_DEV void epi_scatter(int L, int per, const uint8_t* lflags, EpiShared& sh, int tid, int nthreads) {
  for (int l = tid; l < L; l += nthreads) sh.src_of[epi_dest(sh.rs, per, lflags[l], l)] = l;
}

// block 0, thread 0, after the scan: the next control word, staged
MT_DEV void epi_stage_ctl(const RankShared& rs, int L, int32_t* ctl, int max_rounds) {
  int r_next = ctl[0] + 1;
  ctl[2] = r_next;
  ctl[3] = (r_next < max_rounds && rank_any_running(rs, L)) ? 1 : 0;
}

// A dying lane's visited row OR-ed into its code's pruned_visited row,
// 16 bytes a load where the row allows it; every writer stores 1, so
// lanes of one code racing on a byte agree.
MT_DEV void epi_fold_visited(const uint8_t* vis, uint8_t* pvr, int CL, int tid, int nthreads) {
  if ((CL & 15) == 0 && (((uintptr_t)vis | (uintptr_t)pvr) & 15) == 0) {
    for (int i = tid; i < CL / 16; i += nthreads) {
      const mt_u4 v = ((const mt_u4*)vis)[i];
      const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if ((wd[b >> 2] >> (8 * (b & 3))) & 0xFF) pvr[16 * i + b] = 1;
    }
  } else {
    for (int j = tid; j < CL; j += nthreads)
      if (vis[j]) pvr[j] = 1;
  }
}

// part 0 (each block, before its first barrier): the unit table, fields
// tid, tid + nthreads, ...; then thread 0 sums the counts into ustart.
MT_DEV void epi_units_fields(const Planes& P, const Planes& Sc, EpiShared& sh, int tid, int nthreads) {
  for (int f = tid; f < NFIELDS; f += nthreads) {
    const int64_t rb = P.row_bytes[f];
    const uintptr_t al = (uintptr_t)P.p[f] | (uintptr_t)Sc.p[f];
    const int shift = ((rb & 15) == 0 && (al & 15) == 0) ? 4 : (((rb & 3) == 0 && (al & 3) == 0) ? 2 : 0);
    sh.base[0][f] = (uint8_t*)P.p[f];
    sh.base[1][f] = (uint8_t*)Sc.p[f];
    sh.rb[f] = rb;
    sh.ushift[f] = (uint8_t)shift;
    sh.ustart[f + 1] = (int32_t)(rb >> shift);
  }
}

MT_DEV void epi_units_prefix(EpiShared& sh) {
  sh.ustart[0] = 0;
  for (int f = 0; f < NFIELDS; ++f) sh.ustart[f + 1] += sh.ustart[f];
}

// Thread tid of nthreads moves units tid, tid + nthreads, ... of lane s's
// row in batch `from` to lane d's row in batch `to` (0: the state, 1:
// scratch), EPI_BATCH units loaded before any is stored, so that a
// thread keeps that many loads in flight whatever the planes' sizes. The
// planes in `zero` are written as zeros, those in neither mask are left
// alone. Whatever the masks, unit v is thread v mod nthreads's, so a
// byte is written by one thread only.
MT_DEV void epi_move_row(const EpiShared& sh, int from, int to, int s, int d, uint64_t copy, uint64_t zero,
                         int tid, int nthreads) {
  const int total = sh.ustart[NFIELDS];
  const mt_u4 z = {0, 0, 0, 0};
  int f = 0;
  for (int v0 = tid; v0 < total; v0 += EPI_BATCH * nthreads) {
    mt_u4 buf[EPI_BATCH];
    uint8_t* dst[EPI_BATCH];
    int sft[EPI_BATCH];
#pragma unroll
    for (int k = 0; k < EPI_BATCH; ++k) {
      const int v = v0 + k * nthreads;
      dst[k] = nullptr;
      sft[k] = 0;
      buf[k] = z;
      if (v >= total) continue;
      while (v >= sh.ustart[f + 1]) ++f;
      const bool zr = (zero >> f) & 1;
      if (!zr && !((copy >> f) & 1)) continue;
      sft[k] = sh.ushift[f];
      const int64_t off = (int64_t)(v - sh.ustart[f]) << sft[k];
      dst[k] = sh.base[to][f] + sh.rb[f] * d + off;
      if (zr) continue;
      const uint8_t* src = sh.base[from][f] + sh.rb[f] * s + off;
      if (sft[k] == 4) buf[k] = *(const mt_u4*)src;
      else if (sft[k] == 2) buf[k].x = *(const uint32_t*)src;
      else buf[k].x = *src;
    }
#pragma unroll
    for (int k = 0; k < EPI_BATCH; ++k) {
      if (!dst[k]) continue;
      if (sft[k] == 4) *(mt_u4*)dst[k] = buf[k];
      else if (sft[k] == 2) *(uint32_t*)dst[k] = buf[k].x;
      else *dst[k] = (uint8_t)buf[k].x;
    }
  }
}

// Parts 2 and 3 split each destination lane's row among wpr warps: work
// unit u is destination u / wpr, and its thread wl of warp u % wpr is
// thread (u % wpr) * 32 + wl of wpr * 32 for epi_move_row.
//
// part 2: the row that moves into d goes to scratch row d (a dying
// source's zeroed planes are not copied: part 3 writes them), and a dying
// source's visited row is OR-ed into pruned_visited, moved or not. Only
// the state is read and only scratch and pv are written.
MT_DEV void epi_gather_unit(const Planes& P, const uint8_t* lflags, const EpiShared& sh, uint8_t* pv, int d,
                            int tid, int nthreads) {
  const int s = sh.src_of[d];
  const bool dies = lflags[s] & EF_DIES;
  if (s != d) epi_move_row(sh, 0, 1, s, d, dies ? ~EPI_ZEROED : ALL_FIELDS, 0, tid, nthreads);
  if (dies)
    epi_fold_visited(PL(uint8_t, F_VISITED) + (int64_t)s * P.CL,
                     pv + (int64_t)PL(int32_t, F_CODE_ID)[s] * P.CL, P.CL, tid, nthreads);
}

// part 3: a moved row comes back from scratch; a dying source's zeroed
// planes are written as zeros where it now lies, which is its old place
// when it does not move. Only scratch is read, and each byte of the state
// is written by one thread.
MT_DEV void epi_place_unit(const uint8_t* lflags, const EpiShared& sh, int d, int tid, int nthreads) {
  const int s = sh.src_of[d];
  const bool dies = lflags[s] & EF_DIES;
  if (s != d) epi_move_row(sh, 1, 0, d, d, dies ? ~EPI_ZEROED : ALL_FIELDS, dies ? EPI_ZEROED : 0, tid, nthreads);
  else if (dies) epi_move_row(sh, 0, 0, d, d, 0, EPI_ZEROED, tid, nthreads);
}

MT_DEV void epi_commit(int32_t* ctl) {
  ctl[0] = ctl[2];
  ctl[1] = ctl[3];
}
