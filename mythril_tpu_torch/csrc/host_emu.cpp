// Host emulation of the kernels' lane logic, for the CPU tests: the same
// headers compiled as plain C++ (-DMT_HOST_EMU), with loops over lanes
// standing in for the grids (and K1's rank run thread by thread between
// its barriers) of step.cu, inloop.cu, megakernel.cu,
// keccak.cu, solve.cu, transfer.cu, hist.cu, slice.cu and mesh.cu. Built with g++ by
// tests/test_torch_kernel_logic.py and tests/test_torch_mesh_kernels.py; never used on the card.
#include <stdint.h>

#include "hist.cuh"
#include "inloop.cuh"
#include "megakernel.cuh"
#include "mesh.cuh"
#include "slice.cuh"
#include "solve.cuh"
#include "step.cuh"
#include "transfer.cuh"

#include <vector>

extern "C" {

// K1's fork rank in one block of nthreads "threads", run thread by
// thread between the block's barriers (step.cu, part (b)).
static void emu_rank_block(int L, const uint8_t* flags, RankShared& rs, int nthreads) {
  for (int t = 0; t < nthreads; ++t) rank_sum_chunk(L, flags, rs, t, nthreads);
  rank_scan_warps(rs, nthreads);
  for (int t = 0; t < nthreads; ++t) rank_prefix(L, flags, rs, t, nthreads);
  for (int t = 0; t < nthreads; ++t) rank_scatter(L, flags, rs, t, nthreads);
}

static bool emu_rank_ok(int L, int n_shards, int nthreads) {
  return L >= 1 && L <= RANK_MAX_LANES && n_shards >= 1 && L % n_shards == 0 && nthreads >= 32 &&
         nthreads % 32 == 0 && nthreads <= RANK_MAX_THREADS;
}

// K1's rank alone, from given flags: every lane's slot code, and
// whether any lane runs.
int emu_fork_rank(int L, int n_shards, const uint8_t* flags, int nthreads, int32_t* slot,
                  int32_t* any_running) {
  if (!emu_rank_ok(L, n_shards, nthreads)) return 2;
  std::vector<RankShared> rs(1);
  emu_rank_block(L, flags, rs[0], nthreads);
  for (int l = 0; l < L; ++l) slot[l] = fork_slot(L, L / n_shards, flags, rs[0], l);
  *any_running = rank_any_running(rs[0], L);
  return 0;
}

// K1 (step.cu): n_steps steps as one launch runs them, with blocks of
// nthreads threads. The lane pass visits the lanes in ``order`` (null:
// 0..L-1), one warp a lane: a lane steps and its fork is copied before
// the next lane steps.
int emu_step_run(const Planes* Pp, const Bank* Bp, const int32_t* tab, uint8_t* flags,
                 const int32_t* ctl, int n_shards, int n_steps, int nthreads, const int32_t* order) {
  const Planes& P = *Pp;
  const Bank& B = *Bp;
  const int L = P.L;
  if (!emu_rank_ok(L, n_shards, nthreads)) return 2;
  if (ctl && !ctl[1]) return 0;
  std::vector<RankShared> rs(1);
  const int per = L / n_shards;
  for (int step = 0; step < n_steps; ++step) {
    for (int l = 0; l < L; ++l) flags[l] = lane_flags(P, B, tab, l);
    emu_rank_block(L, flags, rs[0], nthreads);
    if (!rank_any_running(rs[0], L)) return 0;
    for (int i = 0; i < L; ++i) {
      const int lane = order ? order[i] : i;
      int dest;
      const int child = fork_slot(L, per, flags, rs[0], lane);
      if (!lane_pass(P, B, tab, flags, child, lane, &dest)) continue;
      copy_row_part(P, P, lane, child, 0, 1);
      fork_child_edits(P, child, dest);
    }
  }
  return 0;
}

// K3
int emu_unsat(const Planes* P, const Pool* pool, uint8_t* out) {
  for (int l = 0; l < P->L; ++l) out[l] = unsat_lane(*P, *pool, l) ? 1 : 0;
  return 0;
}

// K4: plan, gather into scratch with folds, copy back, commit ctl
// (megakernel.cu, with its shard count, flags and gate)
int emu_epilogue_sharded(const Planes* Pp, const Planes* Sp, const uint8_t* prune_revert,
                         const uint8_t* unsat, int32_t* acc, int32_t* order, uint8_t* dying,
                         uint8_t* pv, int32_t* ctl, int max_rounds, int n_shards, int flags,
                         const int32_t* gate) {
  const Planes& P = *Pp;
  const Planes& Sc = *Sp;
  if (P.L > 1024) return 1;
  if (n_shards < 1 || P.L % n_shards != 0) return 2;
  if (!ctl[1]) return 0;
  if (!gate || gate[0]) {
    const bool compact_only = flags & EPI_COMPACT_ONLY;
    uint8_t dead_s[1024], dying_s[1024];
    for (int l = 0; l < P.L; ++l) {
      bool dead = false;
      dying_s[l] = !compact_only && dying_of(P, prune_revert, unsat, l, &dead) ? 1 : 0;
      dead_s[l] = dead ? 1 : 0;
    }
    epi_plan_serial(P, dead_s, dying_s, acc, order, dying, ctl, max_rounds, n_shards, !compact_only);
    for (int d = 0; d < P.L; ++d) copy_row_part(P, Sc, order[d], d, 0, 1);
    for (int d = 0; d < P.L; ++d) epi_fold_lane(P, Sc, order, dying, pv, d, 0, 1);
    for (int d = 0; d < P.L; ++d) copy_row_part(Sc, P, d, d, 0, 1);
  }
  if (flags & EPI_COMMIT) {
    ctl[0] = ctl[2];
    ctl[1] = ctl[3];
  }
  return 0;
}

int emu_epilogue(const Planes* Pp, const Planes* Sp, const uint8_t* prune_revert,
                 const uint8_t* unsat, int32_t* acc, int32_t* order, uint8_t* dying, uint8_t* pv,
                 int32_t* ctl, int max_rounds) {
  return emu_epilogue_sharded(Pp, Sp, prune_revert, unsat, acc, order, dying, pv, ctl, max_rounds,
                              1, EPI_COMMIT, nullptr);
}

// K2, flat rows
int emu_keccak(const uint8_t* data, const int32_t* length, uint8_t* out, int rows, int n,
               int max_blocks) {
  for (int r = 0; r < rows; ++r) {
    WindowGet g{data + (int64_t)r * n, n};
    keccak256_padded(g, length[r], max_blocks, out + (int64_t)r * 32);
  }
  return 0;
}

// K5: one instance at a time, one "thread"
int emu_solve(const int32_t* lits, const int32_t* nvars, const uint8_t* is_input,
              const int8_t* warm, int32_t* status, uint8_t* assign, int32_t* sweeps, int I, int C,
              int V, int flips, uint32_t seed) {
  std::vector<int8_t> val(V), fixed(V);
  std::vector<int32_t> upd(V);
  SolveFlags f;
  for (int i = 0; i < I; ++i)
    solve_instance(lits, nvars, is_input, warm, status, assign, sweeps, C, V, flips, seed, i,
                   val.data(), fixed.data(), upd.data(), &f, 0, 1);
  return 0;
}

// K6 / K7 over host pointers (the table's pointers are host addresses)
int emu_unpack(const uint8_t* buf, const int64_t* table, int nseg) {
  for (int s = 0; s < nseg; ++s) unpack_segment(buf, table + s * SEG_COLS, 0, 1);
  return 0;
}

int emu_pack(uint8_t* out, const int64_t* table, int nseg) {
  for (int s = 0; s < nseg; ++s) pack_segment(out, table + s * SEG_COLS, 0, 1);
  return 0;
}

// K8: every lane's bin, then the snapshot refresh
int emu_op_hist(const uint8_t* code, int n_codes, int CL, int32_t* b_cid, int32_t* b_pc,
                int32_t* b_steps, const int32_t* a_cid, const int32_t* a_pc, const int32_t* a_steps,
                int L, uint32_t* hist, const int32_t* ctl, int refresh) {
  if (ctl && !ctl[1]) return 0;
  for (int l = 0; l < L; ++l) {
    int b = hist_bin(code, n_codes, CL, b_cid[l], b_pc[l], b_steps[l], a_steps[l]);
    if (b < HIST_BINS) hist[b] += 1u;
    if (refresh) {
      b_cid[l] = a_cid[l];
      b_pc[l] = a_pc[l];
      b_steps[l] = a_steps[l];
    }
  }
  return 0;
}

// K9
int emu_slice_ctl(const uint8_t* alive, const int32_t* status, int L, int32_t* ctl, int max_steps) {
  int any_running = 0;
  for (int l = 0; l < L; ++l) any_running |= lane_running(alive, status, l);
  slice_ctl_commit(ctl, any_running, max_steps);
  return 0;
}

// K10: counts per shard (thread per shard), then the plan
int emu_mesh_plan(const Planes* Pp, int n, int flags, uint8_t* export_, int32_t* buf_pos,
                  int32_t* sh, int32_t* mctl, const int32_t* ctl) {
  const Planes& P = *Pp;
  if (n < 1 || n > MESH_MAX_SHARDS || P.L % n != 0) return 2;
  if (ctl && !ctl[1]) return 0;
  int32_t sur[MESH_MAX_SHARDS], dbase[MESH_MAX_SHARDS], rbase[MESH_MAX_SHARDS],
      rend[MESH_MAX_SHARDS];
  const int per = P.L / n;
  for (int s = 0; s < n; ++s) mesh_count_shard(P, per, s, n, sh);
  if (!(flags & MESH_PLAN)) return 0;
  int moved = mesh_plan_scalars(per, n, sh, sur, dbase, rbase, rend);
  mesh_commit(sh, n, moved, flags, mctl);
  for (int s = 0; s < n; ++s)
    mesh_plan_shard(P, per, n, s, sh, sur, dbase, rbase, rend, moved, export_, buf_pos);
  return 0;
}

// K11: every exported lane's move
int emu_mesh_steal(const Planes* Pp, int n, const uint8_t* export_, const int32_t* buf_pos,
                   const int32_t* sh, const int32_t* ctl, const int32_t* gate) {
  const Planes& P = *Pp;
  if (n < 1 || n > MESH_MAX_SHARDS || P.L % n != 0) return 2;
  if ((ctl && !ctl[1]) || (gate && !gate[0])) return 0;
  for (int l = 0; l < P.L; ++l) {
    if (!export_[l]) continue;
    copy_row_part(P, P, l, mesh_target(sh, P.L / n, n, buf_pos[l]), 0, 1);
    mesh_kill_part(P, l, 0, 1);
  }
  return 0;
}

// K12: the deal's order, the gather into scratch, the copy back
int emu_mesh_deal(const Planes* Pp, const Planes* Sp, int n, int32_t* order) {
  const Planes& P = *Pp;
  if (n < 1 || n > MESH_MAX_SHARDS || P.L % n != 0 || P.L > 1024) return 2;
  int32_t packed[1024];
  mesh_deal_order(P, n, packed, order);
  for (int d = 0; d < P.L; ++d) copy_row_part(P, *Sp, order[d], d, 0, 1);
  for (int d = 0; d < P.L; ++d) copy_row_part(*Sp, P, d, d, 0, 1);
  return 0;
}
}
