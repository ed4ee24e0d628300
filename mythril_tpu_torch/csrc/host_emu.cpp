// Host emulation of the kernels' lane logic, for the CPU tests: the same
// headers compiled as plain C++ (-DMT_HOST_EMU), with loops over lanes
// standing in for the grids (and K1's rank, K3 and K4 run thread by
// thread between their barriers) of step.cu, inloop.cu, megakernel.cu,
// keccak.cu, solve.cu, transfer.cu, hist.cu, slice.cu and mesh.cu. Built with g++ by
// tests/test_torch_kernel_logic.py, tests/test_torch_mesh_kernels.py,
// tests/test_torch_mesh_cards.py and tests/test_torch_transfer.py; never
// used on the card.
#include <stdint.h>

#include "hist.cuh"
#include "inloop.cuh"
#include "megakernel.cuh"
#include "mesh.cuh"
#include "slice.cuh"
#include "solve.cuh"
#include "step.cuh"
#include "transfer.cuh"

#include <functional>
#include <vector>

// Runs fn(i) for i in [0, n), ascending or (reverse) descending: the
// threads of one part of a kernel, between two of its barriers. A part
// whose threads read what another thread of the same part writes gives
// different results in the two orders.
template <class F>
static void each(int n, int reverse, F fn) {
  if (reverse)
    for (int i = n - 1; i >= 0; --i) fn(i);
  else
    for (int i = 0; i < n; ++i) fn(i);
}

// K5's block (solve.cuh solve_block) on the host. A part (each) is
// held until the next barrier; at a barrier (sync, sync_or) every thread
// in turn runs all its held parts and then the barrier's own part, so a
// thread's parts between two barriers run back to back, as on the card,
// and another thread's may come before or after them. sync_or ORs the
// threads' results; a warp's minimum is taken over its threads' values
// once all have run.
struct SolveBlockEmu {
  int n, reverse;
  std::vector<std::function<void(int)>> held;
  std::vector<int> vals[2];
  int32_t* dst[2] = {nullptr, nullptr};
  template <class F>
  void each(F f) {
    held.emplace_back(f);
  }
  void sync() {
    sync_or([](int) { return false; });
  }
  template <class F>
  bool sync_or(F f) {
    bool any = false;
    ::each(n, reverse, [&](int t) {
      for (auto& part : held) part(t);
      any |= (bool)f(t);
    });
    held.clear();
    for (int k = 0; k < 2; ++k) {
      if (!dst[k]) continue;
      for (int w = 0; w * 32 < n; ++w) {
        int m = 0x7fffffff;
        for (int t = w * 32; t < w * 32 + 32 && t < n; ++t) m = vals[k][t] < m ? vals[k][t] : m;
        dst[k][w] = m;
      }
      dst[k] = nullptr;
    }
    return any;
  }
  void warp_min(int32_t* w, int v, int t) {
    const int k = (!dst[0] || dst[0] == w) ? 0 : 1;
    dst[k] = w;
    vals[k].resize(n);
    vals[k][t] = v;
  }
  int block_min(const int32_t* w) {
    int m = 0x7fffffff;
    for (int i = 0; i * 32 < n; ++i) m = w[i] < m ? w[i] : m;
    return m;
  }
};

extern "C" {

// K1's fork rank in one block of nthreads "threads", run thread by
// thread between the block's barriers (step.cu, part (b)).
static void emu_rank_block(int L, const uint8_t* flags, StepShared& ss, int nthreads) {
  for (int t = 0; t < nthreads; ++t) rank_sum_chunk(L, flags, ss.rs, t, nthreads);
  rank_scan_warps(ss.rs, nthreads);
  for (int t = 0; t < nthreads; ++t) rank_prefix(L, flags, ss.rs, t, nthreads);
  for (int t = 0; t < nthreads; ++t) rank_scatter(L, flags, ss, t, nthreads);
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
  std::vector<StepShared> ss(1);
  emu_rank_block(L, flags, ss[0], nthreads);
  for (int l = 0; l < L; ++l) slot[l] = fork_slot(L, L / n_shards, flags, ss[0], l);
  *any_running = rank_any_running(ss[0].rs, L);
  return 0;
}

// K1 (step.cu): n_steps steps as one launch runs them, with blocks of
// nthreads threads. Part (a) and the lane pass visit the lanes in
// ``order`` (null: 0..L-1), the lane pass one warp a lane: a lane steps
// and its fork is copied before the next lane steps. With ``hist`` (and
// ``rec``, int32[2L]) every step's retired opcodes are folded as the
// kernel's stats instance folds them: each lane's previous record
// compared and its new one taken in part (a), the last step's fold after
// the loop, the bins added into ``hist`` on every exit.
int emu_step_run(const Planes* Pp, const Bank* Bp, const int32_t* tab, uint8_t* flags,
                 const int32_t* ctl, uint32_t* hist, int32_t* rec, int n_shards, int n_steps, int nthreads,
                 const int32_t* order) {
  const Planes& P = *Pp;
  const Bank& B = *Bp;
  const int L = P.L;
  if (!emu_rank_ok(L, n_shards, nthreads) || (hist && !rec)) return 2;
  if (ctl && !ctl[1]) return 0;
  std::vector<StepSharedHist> ss(1);
  StepSharedHist& sh = ss[0];
  for (int i = 0; i < HIST_BINS; ++i) sh.bins[i] = 0;
  auto flush = [&]() {
    if (hist)
      for (int i = 0; i < HIST_BINS; ++i)
        if (sh.bins[i]) hist[i] += sh.bins[i];
  };
  const int per = L / n_shards;
  for (int step = 0; step < n_steps; ++step) {
    for (int i = 0; i < L; ++i) {
      const int l = order ? order[i] : i;
      if (hist) {
        if (step) hist_fold(P, rec, sh.bins, l);
        hist_record(P, B.code, rec, l);
      }
      flags[l] = lane_flags(P, B, tab, l);
    }
    emu_rank_block(L, flags, sh, nthreads);
    if (!rank_any_running(sh.rs, L)) {
      flush();
      return 0;
    }
    for (int i = 0; i < L; ++i) {
      const int lane = order ? order[i] : i;
      int dest;
      const int child = fork_slot(L, per, flags, sh, lane);
      if (!lane_pass(P, B, tab, flags, child, lane, &dest)) continue;
      copy_row_part(P, P, lane, child, 0, 1);
      fork_child_edits(P, child, dest);
    }
  }
  if (hist && n_steps > 0)
    for (int l = 0; l < L; ++l) hist_fold(P, rec, sh.bins, l);
  flush();
  return 0;
}

// K3 (inloop.cu): the pool staged by a block of 128 threads, then one
// warp per lane, each part of the warp's work run thread by thread
// between its __syncwarp()s; the warp's shared slice is filled with a
// pattern before every lane, so a read of an entry that was not staged
// shows.
int emu_unsat(const Planes* Pp, const Pool* pool, uint8_t* out, int reverse) {
  const Planes& P = *Pp;
  if (pool->V > POOL_MAX_VARS || pool->V <= 0 || pool->C <= 0 || pool->W <= 0 || P.P <= 0) return 2;
  const int64_t nbytes = unsat_warp_bytes(P.P, pool->V);
  std::vector<mt_u4> pool_mem(unsat_pool_bytes(pool->V, pool->C, pool->W) / 16), mem(nbytes / 16);
  Pool sp = *pool;
  each(128, reverse, [&](int t) { sp = unsat_stage_pool(*pool, (uint8_t*)pool_mem.data(), t, 128); });
  uint8_t* base = (uint8_t*)mem.data();
  const UnsatWarp w = unsat_warp(base, P.P, pool->V);
  for (int lane = 0; lane < P.L; ++lane) {
    bool hit = false;
    if (unsat_eligible(P, lane)) {
      for (int64_t i = 0; i < nbytes; ++i) base[i] = (uint8_t)(0xA5 ^ i);
      each(32, reverse, [&](int t) { unsat_stage(P, lane, w, t); });
      each(32, reverse, [&](int t) { hit |= unsat_r13(P.P, w, t); });
      if (!hit) {
        each(32, reverse, [&](int t) { unsat_seed(sp, P.P, w, t); });
        for (int sweep = 0; sweep < PROP_SWEEPS; ++sweep) {
          each(32, reverse, [&](int t) { hit |= unsat_clauses(sp, w, t); });
          each(32, reverse, [&](int t) { hit |= unsat_apply(sp, w, t); });
        }
      }
    }
    out[lane] = hit ? 1 : 0;
  }
  return 0;
}

// K4 (megakernel.cu): one cooperative launch of nblocks blocks of
// nthreads threads, its three parts run thread by thread between the grid
// barriers, in either order. The blocks' atomics are one sum: u32
// addition does not care about order.
int emu_epilogue(const Planes* Pp, const Planes* Sp, const uint8_t* prune_revert, const uint8_t* unsat,
                 int32_t* acc, int32_t* order, uint8_t* dying, uint8_t* lflags, uint8_t* pv, int32_t* ctl,
                 int max_rounds, int n_shards, int flags, const int32_t* gate, int nblocks, int nthreads,
                 int reverse) {
  const Planes& P = *Pp;
  const Planes& Sc = *Sp;
  const int L = P.L;
  if (L <= 0 || L > EPI_MAX_LANES) return 1;
  if (n_shards < 1 || L % n_shards != 0) return 2;
  if (nblocks < 1 || nthreads < 32 || nthreads % 32 || nthreads > 32 * EPI_MAX_WARPS) return 3;
  if (!ctl[1]) return 0;
  if (gate && !gate[0]) {
    if (flags & EPI_COMMIT) epi_commit(ctl);
    return 0;
  }
  const bool compact_only = flags & EPI_COMPACT_ONLY;
  const int per = L / n_shards, G = nblocks * nthreads, wpb = nthreads / 32, nwarps = nblocks * wpb;
  std::vector<EpiShared> sh(nblocks);
  each(nblocks, reverse, [&](int b) {
    each(nthreads, reverse, [&](int t) { epi_units_fields(P, Sc, sh[b], t, nthreads); });
    epi_units_prefix(sh[b]);
  });
  // (1)
  uint32_t total[4] = {0, 0, 0, 0};
  each(G, reverse, [&](int gtid) {
    uint32_t f[4];
    epi_plan_lanes(P, prune_revert, unsat, lflags, dying, compact_only, gtid, G, f);
    for (int k = 0; k < 4; ++k) total[k] += f[k];
  });
  if (!compact_only)
    for (int k = 0; k < 4; ++k) acc[k] = (int32_t)((uint32_t)acc[k] + total[k]);
  // (2)
  each(nblocks, reverse, [&](int b) {
    RankShared& rs = sh[b].rs;
    each(nthreads, reverse, [&](int t) { rank_sum_chunk(L, lflags, rs, t, nthreads); });
    rank_scan_warps(rs, nthreads);
    each(nthreads, reverse, [&](int t) { rank_prefix(L, lflags, rs, t, nthreads); });
    each(nthreads, reverse, [&](int t) { epi_scatter(L, per, lflags, sh[b], t, nthreads); });
  });
  each(G, reverse, [&](int gtid) {
    for (int d = gtid; d < L; d += G) order[d] = sh[gtid / nthreads].src_of[d];
  });
  if (!compact_only) epi_stage_ctl(sh[0].rs, L, ctl, max_rounds);
  const int wpr = nwarps >= L ? nwarps / L : 1;
  each(nwarps, reverse, [&](int gw) {
    for (int u = gw; u < L * wpr; u += nwarps)
      each(32, reverse, [&](int wl) {
        epi_gather_unit(P, lflags, sh[gw / wpb], pv, u / wpr, (u % wpr) * 32 + wl, wpr * 32);
      });
  });
  // (3)
  each(nwarps, reverse, [&](int gw) {
    for (int u = gw; u < L * wpr; u += nwarps)
      each(32, reverse, [&](int wl) {
        epi_place_unit(lflags, sh[gw / wpb], u / wpr, (u % wpr) * 32 + wl, wpr * 32);
      });
  });
  if (flags & EPI_COMMIT) epi_commit(ctl);
  return 0;
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

// K5 (solve.cu): each instance's block of nthreads threads, its parts
// run thread by thread (ascending or descending) between its barriers
// (SolveBlockEmu); the block's shared memory is filled with a pattern
// first.
int emu_solve(const int32_t* lits, const int32_t* nvars, const uint8_t* is_input,
              const int8_t* warm, int32_t* status, uint8_t* assign, int32_t* sweeps, int I, int C,
              int V, int flips, uint32_t seed, int nthreads, int reverse) {
  if (nthreads < 32 || nthreads % 32 || nthreads > SOLVE_MAX_THREADS || V <= 0 || V > SOLVE_MAX_VARS) return 2;
  const SolveArgs a{lits, nvars, is_input, warm, status, assign, sweeps, C, V, flips, seed,
                    ((uintptr_t)lits & 15) == 0 && C % 4 == 0};
  std::vector<mt_u4> smem(solve_smem_bytes(C, V, nthreads) / 16 + 1);
  for (int i = 0; i < I; ++i) {
    for (size_t b = 0; b < smem.size() * 16; ++b) ((uint8_t*)smem.data())[b] = (uint8_t)(0xA5 ^ b);
    SolveShared sh;
    for (size_t b = 0; b < sizeof(sh); ++b) ((uint8_t*)&sh)[b] = (uint8_t)(0x5A ^ b);
    SolveBlockEmu blk{nthreads, reverse};
    solve_block(blk, a, solve_carve((uint8_t*)smem.data(), C, V, solve_chunk(C, V, nthreads)), sh, i);
    blk.sync();  // the block's exit: its last parts run
  }
  return 0;
}

// K6 / K7 (transfer.cu) over host pointers (the table's addresses are
// host addresses): nblocks blocks of nthreads threads, each block staging
// the table into its shared copy (filled with a pattern first, so a row
// it fails to stage shows), then each of its threads taking its units of
// the block's chunks, grid-stride; blocks and threads in either order.
int emu_xfer(const XferSeg* table, int nseg, uint32_t total, int nblocks, int nthreads, int reverse) {
  if (nseg < 0 || nseg > XFER_MAX_SEGS || nblocks < 1 || nthreads < 1) return 2;
  if (!nseg || !total) return 0;
  std::vector<XferSeg> sm(nseg);
  each(nblocks, reverse, [&](int b) {
    for (int64_t i = 0; i < nseg * (int64_t)sizeof(XferSeg); ++i) ((uint8_t*)sm.data())[i] = (uint8_t)(0xA5 ^ i);
    each(nthreads, reverse, [&](int t) { xfer_stage(table, nseg, sm.data(), t, nthreads); });
    each(nthreads, reverse, [&](int t) { xfer_thread(sm.data(), nseg, total, b, nblocks, t, nthreads); });
  });
  return 0;
}

// K8: every lane's bin
int emu_op_hist(const uint8_t* code, int n_codes, int CL, const int32_t* b_cid, const int32_t* b_pc,
                const int32_t* b_steps, const int32_t* a_steps, int L, uint32_t* hist) {
  for (int l = 0; l < L; ++l) {
    int b = hist_bin(code, n_codes, CL, b_cid[l], b_pc[l], b_steps[l], a_steps[l]);
    if (b < HIST_BINS) hist[b] += 1u;
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

// K10/K11 (mesh.cu): one launch of nblocks blocks of nthreads threads,
// each block's parts run thread by thread between its barriers (warp 0's
// collective steps over the arrays, mesh.cuh), in either order; a block's
// shared memory is filled with a pattern first, so a read of an entry no
// part wrote shows. A launch that plans and moves meets at the grid
// barrier: every block plans before any block moves. A launch that moves
// from a given plan has none, so each block's moves run right after its
// own plan, before the next block plans.
int emu_mesh_steal(const Planes* Pp, int n, int flags, uint8_t* export_, int32_t* buf_pos, int32_t* sh,
                   int32_t* mctl, const int32_t* ctl, int nblocks, int nthreads, int reverse) {
  const Planes& P = *Pp;
  const int L = P.L;
  if (n < 1 || n > MESH_MAX_SHARDS || L < 1 || L % n != 0) return 2;
  if (nblocks < 1 || nthreads < L || nthreads % 32 || nthreads > MESH_MAX_LANES) return 3;
  if (ctl && !ctl[1]) return 0;
  std::vector<MeshShared> ms(nblocks);
  auto plan = [&](int b) {
    MeshShared& m = ms[b];
    for (int i = 0; i < (int)sizeof(MeshShared); ++i) ((uint8_t*)&m)[i] = (uint8_t)(0xA5 ^ i);
    for (int w = 0; w < MESH_MAX_WARPS; ++w) m.ballot[w][0] = m.ballot[w][1] = 0;  // the ballots' OR below
    // (a)
    each(nthreads, reverse, [&](int t) {
      mesh_unit_fields(P, m, t, nthreads);
      const uint8_t bits = mesh_lane_bits(P, export_, flags, t);
      m.ballot[t >> 5][0] |= (uint32_t)(bits & 1) << (t & 31);
      m.ballot[t >> 5][1] |= (uint32_t)((bits >> 1) & 1) << (t & 31);
    });
    // (b)
    mesh_warp_counts(m, nthreads >> 5);
    mesh_units_prefix(m);
    each(32, reverse, [&](int j) { mesh_shard_pair(m, L, n, j); });
    mesh_warp_scans(m);
    each(32, reverse, [&](int j) { mesh_shard_bases(m, L, n, flags, j); });
    // (c)
    each(nthreads, reverse,
         [&](int t) { mesh_lane_plan(m, L, n, flags, b == 0, export_, buf_pos, sh, mctl, t); });
  };
  auto moves = [&](int b) {  // (d)
    if (!ms[b].nmove) return;
    each(nthreads, reverse, [&](int t) {
      mesh_move_units(ms[b], (uint32_t)(b * nthreads + t), (uint32_t)(nblocks * nthreads));
    });
  };
  if (flags & MESH_PLAN) {
    each(nblocks, reverse, plan);
    each(nblocks, reverse, moves);
  } else {
    each(nblocks, reverse, [&](int b) {
      plan(b);
      moves(b);
    });
  }
  return 0;
}

// K12 (mesh.cu): one launch of nblocks blocks of nthreads threads, each
// block's parts run thread by thread between its barriers (warp 0's
// scans over the arrays), in either order, a block's shared memory
// filled with a pattern first; every block plans and gathers its units
// of the moving rows before any block copies them into their slots (the
// grid barrier).
int emu_mesh_deal(const Planes* Pp, const Planes* Sp, int n, int32_t* order, int nblocks, int nthreads,
                  int reverse) {
  const Planes& P = *Pp;
  const int L = P.L;
  if (n < 1 || n > MESH_MAX_SHARDS || L < 1 || L % n != 0 || Sp->L < L) return 2;
  if (nblocks < 1 || nthreads < L || nthreads % 32 || nthreads > MESH_MAX_LANES) return 3;
  std::vector<MeshShared> ms(nblocks);
  const uint32_t G = (uint32_t)(nblocks * nthreads);
  each(nblocks, reverse, [&](int b) {
    MeshShared& m = ms[b];
    for (int i = 0; i < (int)sizeof(MeshShared); ++i) ((uint8_t*)&m)[i] = (uint8_t)(0xA5 ^ i);
    for (int w = 0; w < MESH_MAX_WARPS; ++w) m.ballot[w][0] = m.ballot[w][1] = 0;  // the ballots' OR below
    // (a)
    each(nthreads, reverse, [&](int t) {
      mesh_unit_fields(P, m, t, nthreads, Sp);
      m.ballot[t >> 5][0] |= (uint32_t)(mesh_lane_bits(P, nullptr, MESH_PLAN, t) & 1) << (t & 31);
    });
    // (b)
    mesh_warp_counts(m, nthreads >> 5);
    mesh_units_prefix(m);
    // (c)
    each(nthreads, reverse,
         [&](int t) { m.ballot[t >> 5][1] |= (uint32_t)(mesh_deal_slot(m, L, n, t) != t) << (t & 31); });
    // (d)
    mesh_warp_counts(m, nthreads >> 5);
    // (e)
    each(nthreads, reverse, [&](int t) { mesh_deal_record(m, L, n, b == 0, order, t); });
    if (!m.nmove) return;
    each(nthreads, reverse,
         [&](int t) { mesh_move_units(m, (uint32_t)(b * nthreads + t), G, MESH_TO_SCRATCH); });
  });
  // the grid barrier
  each(nblocks, reverse, [&](int b) {
    if (!ms[b].nmove) return;
    each(nthreads, reverse,
         [&](int t) { mesh_move_units(ms[b], (uint32_t)(b * nthreads + t), G, MESH_FROM_SCRATCH); });
  });
  return 0;
}

// The cross-card exchange (mesh.cu mesh_cards_kernel): one launch on card
// ``card`` of nblocks blocks of nthreads threads, each block's parts run
// thread by thread between its barriers (warp 0's collective steps over
// the arrays), in either order, a block's shared memory filled with a
// pattern first. XC_PLAN's blocks all plan before any block moves (its
// grid barrier); XC_PULL's blocks each move right after their own plan
// (it has no barrier). X holds host pointers: the CPU "cards".
int emu_mesh_cards(const Planes* Pp, const Planes* Sd, const CardPeers* X, int n, int card, int cards, int mode,
                   int32_t* held, int32_t* mctl, int32_t* ctl, int max_rounds, int nblocks, int nthreads,
                   int reverse) {
  const Planes& P = *Pp;
  if (cards < 1 || cards > MESH_MAX_CARDS || card < 0 || card >= cards || n % cards || n > MESH_MAX_SHARDS) return 2;
  const int nl = n / cards;
  if (P.L < 1 || P.L % nl || Sd->L < P.L || mode < XC_COUNT || mode > XC_PULL) return 2;
  if (nblocks < 1 || nthreads < P.L || nthreads < 64 || nthreads % 32 || nthreads > MESH_MAX_LANES) return 3;
  if (ctl && !ctl[1]) return 0;
  const int per = P.L / nl;
  std::vector<MeshShared> ms(nblocks);
  const uint32_t G = (uint32_t)(nblocks * nthreads);
  auto plan = [&](int b) {
    MeshShared& m = ms[b];
    for (int i = 0; i < (int)sizeof(MeshShared); ++i) ((uint8_t*)&m)[i] = (uint8_t)(0xA5 ^ i);
    for (int w = 0; w < MESH_MAX_WARPS; ++w) m.ballot[w][0] = m.ballot[w][1] = 0;  // the ballots' OR below
    // (a)
    each(nthreads, reverse, [&](int t) {
      mesh_unit_fields(P, m, t, nthreads, Sd);
      if (mode != XC_PULL) {
        const uint8_t bits = mesh_lane_bits(P, nullptr, MESH_PLAN, t);
        m.ballot[t >> 5][0] |= (uint32_t)(bits & 1) << (t & 31);
        m.ballot[t >> 5][1] |= (uint32_t)((bits >> 1) & 1) << (t & 31);
      }
      if (mode != XC_COUNT)
        for (int i = t; i < 2 * n; i += nthreads) m.gc[i] = mode == XC_PLAN ? X->gath[card][i] : held[i];
      if (t == 0) m.peers = X;
    });
    if (mode == XC_COUNT) {
      mesh_warp_counts(m, nthreads >> 5);
      each(nthreads, reverse, [&](int t) { mesh_card_counts(m, *X, per, nl, card, cards, t); });
      return;
    }
    // (b)
    mesh_units_prefix(m);
    if (mode == XC_PLAN) mesh_warp_counts(m, nthreads >> 5);
    mesh_gathered_total(m, n);
    each(32, reverse, [&](int j) { mesh_shard_pair(m, n * per, n, j, true); });
    mesh_warp_scans(m);
    each(32, reverse, [&](int j) { mesh_shard_bases(m, n * per, n, MESH_STEAL_ROUND_FLAGS, j); });
    mesh_card_run(m, nl, card, mode);
    // (c)
    each(nthreads, reverse, [&](int t) {
      if (mode == XC_PULL) {
        mesh_card_pull_plan(m, per, n, nl, card, t);
        return;
      }
      if (b == 0 && t == 0) mesh_card_commit(m, n, held, mctl, ctl, max_rounds);
      mesh_card_lane_plan(m, per, n, nl, card, t);
    });
  };
  auto moves = [&](int b) {  // (d)
    if (mode == XC_COUNT || !ms[b].nmove) return;
    each(nthreads, reverse, [&](int t) {
      mesh_move_units(ms[b], (uint32_t)(b * nthreads + t), G, mode == XC_PLAN ? MESH_STEAL_MOVES : MESH_FROM_PEERS);
    });
  };
  if (mode == XC_PLAN) {
    each(nblocks, reverse, plan);
    each(nblocks, reverse, moves);
  } else {
    each(nblocks, reverse, [&](int b) {
      plan(b);
      moves(b);
    });
  }
  return 0;
}
}
