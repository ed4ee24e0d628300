// K10-K12 logic: the mesh tiers on one card (replaces
// mythril_tpu/laser/tpu/mesh.py). A mesh of n shards is n contiguous
// blocks of per = L / n lanes of one batch, as shard_map sees the
// lane-sharded planes. What crossed devices there (the all_gather of the
// counts, the all_to_all of the exported rows, the global deal) is a
// plan in shared memory and row copies here.
//
//   sh   = int32[3n]: occ (running lanes), alive_c (alive lanes), filled
//          (lanes each shard imports), per shard
//   mctl = int32[4]: [do_steal, moved, steal_events, steal_lanes]
//
// K10 (the counts and the steal plan) and K11 (the lane moves) are one
// kernel (mesh.cu), written here as the parts of one cooperative launch
// split at its barriers, each a function of the thread's place, so the
// host emulation runs them thread by thread in either order:
//  (a) one thread a lane loads the lane's bit (running; or exported, when
//      the moves come from a given plan) and alive bit; each warp's two
//      ballots go to shared memory; the threads fill the unit table of a
//      row, a plane each; __syncthreads();
//  (b) warp 0: the exclusive scan of the warps' packed counts, so that
//      the count of any lane prefix is one shared load and two popcounts
//      (mesh_count_at); then the shard-level scalars, two shards a lane
//      (n <= 64), as shuffle scans: target, surplus, deficit capped by
//      free lanes, the three exclusive cumsums, moved, the spread gate
//      (one thread of warp 1 sums the unit table meanwhile);
//      __syncthreads();
//  (c) one thread a lane: its rank among its shard's running lanes is a
//      difference of two prefix counts (a segmented scan), dest a binary
//      search over recv_end; block 0 writes the plan, sh and mctl; each
//      exporter writes its move's source and target into shared memory;
//      __syncthreads();
//  (d) when there are lanes to move (after one grid barrier, if the
//      launch also planned): every thread of the grid takes units of the
//      moved rows (mesh_move_units), grid-stride.
// No thread loops over a shard's lanes or over the shards for a lane.
//
// K12 (the deal, mesh_deal_kernel) reuses (a), (b) and the moves: (a)
// ballots the running bits; (b) warp 0 scans them; (c) one thread a lane
// takes its packed place p (running lanes first, stable) and its slot
// (p mod n) * per + p div n, and ballots whether the slot is not its
// own lane; (b) again scans those ballots; (e) one thread a lane: block
// 0 writes order[slot] = lane, and each lane that moves records its move
// at its rank among the moving lanes; then the grid copies the moving
// rows into rows 0.. of a scratch batch and, after one grid barrier,
// from there into their slots (mesh_move_units).
//
// The cross-card exchange (mesh_cards_kernel) is the steal of the fused
// mesh tier when the n shards lie on several cards, nl = n / cards
// contiguous shards a card, each card's batch its own lanes (card k holds
// shards k nl .. k nl + nl - 1). It reuses the parts above in three
// modes, each one launch on each card:
//  XC_COUNT: (a) over the card's lanes, warp 0's scan, then a thread a
//      (card, own shard) pair stores the shard's [running, alive] into
//      that card's gathered buffer (i32[2n], every card's copy of the
//      reference's all_gather, mesh.py:142);
//  XC_PLAN: every block loads the gathered counts (the card's own
//      buffer) and derives the shard scalars from them (part (b) with
//      gathered counts: the same plan on every card), ranks the card's
//      running lanes from its own ballots (part (c)), and the grid moves
//      the card's exporters (part (d)): to a target lane of its own
//      shards in place, or to row gidx - donor_base[first own shard] of
//      the card's send batch; either way the exporter dies with its
//      MESH_KILLED planes zeroed. Block 0 writes mctl (mesh_commit),
//      copies the counts into the card's held buffer (XC_PULL reads
//      that, so the next round's XC_COUNT may overwrite the gathered
//      buffer once every card has planned) and stages the loop's next
//      continue bit from the mesh-wide running total (the reference's
//      psum in its loop condition);
//  XC_PULL: every block derives the plan from the held counts again and
//      copies each row another card exported to this card from that
//      card's send batch (a peer pointer; on virtual cards of one device
//      a local one) into its target lane: import i of the card is global
//      index recv_base[first own shard] + i, its donor the shard whose
//      [donor_base, donor_base + surplus) holds it (the reference's
//      place, mesh.py:221-224).
// The exports of a card are one run of global donor indices, and its
// imports one run of global receiver indices, because both bases are
// exclusive cumsums over the shards and a card's shards are contiguous.
#pragma once
#include "common.cuh"

#define MESH_MAX_SHARDS 64
#define MESH_MAX_LANES 1024
#define MESH_MAX_WARPS (MESH_MAX_LANES / 32)
#define MESH_BATCH 4  // units a thread loads before it stores any
#define MESH_MAX_CARDS 8

// the cross-card exchange's modes (mesh_cards_kernel)
#define XC_COUNT 0
#define XC_PLAN 1
#define XC_PULL 2

// what one card's exchange launch sees of every card (passed by value):
// each card's gathered-count buffer (i32[2n]) and its send batch's planes
struct CardPeers {
  int32_t* gath[MESH_MAX_CARDS];
  void* send[MESH_MAX_CARDS][NFIELDS];
};

// flags. Count only (0: occupancy_impl); MESH_PLAN: the steal plan
// (steal_plan); MESH_MOVE alone: the moves of the plan given in export_,
// buf_pos and sh's alive_c column, ungated (steal_apply); MESH_PLAN |
// MESH_MOVE: plan, decide and move in one launch (the fused loop's
// steal_round). MESH_GATE_SPREAD gates the steal on the spread (the fused
// loop, megakernel.py:401-410: moved > 0 and max(occ) - min(occ) > 1;
// else moved > 0); MESH_ACCUM adds the event to mctl[2..3].
#define MESH_PLAN 1
#define MESH_GATE_SPREAD 2
#define MESH_ACCUM 4
#define MESH_MOVE 8
#define MESH_STEAL_ROUND_FLAGS (MESH_PLAN | MESH_GATE_SPREAD | MESH_ACCUM | MESH_MOVE)

// the planes an exporter has zeroed (mesh.py:210-215): its copy owns them
#define MESH_KILLED ((1ull << F_ALIVE) | (1ull << F_STEPS) | (1ull << F_STATIC_PRUNED) | (1ull << F_VISITED))

MT_DEV int mesh_popc(uint32_t x) {
#ifdef MT_HOST_EMU
  return __builtin_popcount(x);
#else
  return __popc(x);
#endif
}

// packed lane counts: the counted bit (running, or exported) in bits
// 0-15, alive in bits 16-31 (at most 1024 lanes each); in the deal's
// second scan, bits 16-31 count the lanes that move
MT_DEV int mp_run(int32_t c) { return c & 0xFFFF; }
MT_DEV int mp_alive(int32_t c) { return (c >> 16) & 0xFFFF; }

// one block's shared memory
struct MeshShared {
  uint32_t ballot[MESH_MAX_WARPS][2];  // per warp: its lanes' counted bits, alive bits
  int32_t wpre[MESH_MAX_WARPS + 1];    // per warp: packed counts of the lanes before it; [nwarps]: totals
  int32_t occ[MESH_MAX_SHARDS], alive_c[MESH_MAX_SHARDS], surplus[MESH_MAX_SHARDS], deficit[MESH_MAX_SHARDS];
  int32_t dbase[MESH_MAX_SHARDS], rbase[MESH_MAX_SHARDS], rend[MESH_MAX_SHARDS];
  int32_t wv[4][32];  // warp 0, a lane's two shards: surplus and deficit sums (then scanned), min and max occ
  int32_t moved, go, nmove;
  // move m: source lane (or, XC_PULL, the donor card's send row) and
  // target lane (a negative target -1 - r: row r of the card's send batch)
  int16_t mv_src[MESH_MAX_LANES], mv_dst[MESH_MAX_LANES];
  int8_t mv_card[MESH_MAX_LANES];    // XC_PULL: move m's donor card, -1 for a move made in place by XC_PLAN
  int32_t gc[2 * MESH_MAX_SHARDS];   // the cross-card modes: the gathered [running, alive] of every shard
  int32_t total, lo;                 // the cross-card modes: running lanes mesh-wide; the card's first move
  const CardPeers* peers;            // XC_PULL: the cards' send batches
  // A lane's row of every plane as one list of units: plane f's row is
  // units ustart[f] .. ustart[f + 1] - 1, each 1 << ushift[f] bytes (16,
  // 4 or 1: the widest its row size and base, and the scratch plane's
  // base where there is one, allow).
  uint8_t* base[NFIELDS];
  uint8_t* sbase[NFIELDS];  // the deal's scratch batch: plane f
  int64_t rb[NFIELDS];
  int32_t ustart[NFIELDS + 1];
  uint8_t ushift[NFIELDS];
};

// part (a): lane t's bits (0 past the lanes)
MT_DEV uint8_t mesh_lane_bits(const Planes& P, const uint8_t* export_, int flags, int t) {
  if (t >= P.L) return 0;
  if ((flags & MESH_MOVE) && !(flags & MESH_PLAN)) return export_[t] ? 1 : 0;
  const bool alive = PL(uint8_t, F_ALIVE)[t];
  return (alive && PL(int32_t, F_STATUS)[t] == RUNNING ? 1 : 0) | (alive ? 2 : 0);
}

// part (a), thread t of nthreads: planes t, t + nthreads, ... of the
// unit table (with Sc, the deal's scratch batch, its planes too)
MT_DEV void mesh_unit_fields(const Planes& P, MeshShared& ms, int t, int nthreads, const Planes* Sc = nullptr) {
  for (int f = t; f < NFIELDS; f += nthreads) {
    const int64_t rb = P.row_bytes[f];
    const uintptr_t al = (uintptr_t)P.p[f] | (Sc ? (uintptr_t)Sc->p[f] : 0);
    ms.sbase[f] = Sc ? (uint8_t*)Sc->p[f] : nullptr;
    const int shift = ((rb & 15) == 0 && (al & 15) == 0) ? 4 : (((rb & 3) == 0 && (al & 3) == 0) ? 2 : 0);
    ms.base[f] = (uint8_t*)P.p[f];
    ms.rb[f] = rb;
    ms.ushift[f] = (uint8_t)shift;
    ms.ustart[f + 1] = (int32_t)(rb >> shift);
  }
}

// part (b), one thread (of warp 1 on the card, beside warp 0's scans)
MT_DEV void mesh_units_prefix(MeshShared& ms) {
  ms.ustart[0] = 0;
  for (int f = 0; f < NFIELDS; ++f) ms.ustart[f + 1] += ms.ustart[f];
}

MT_DEV int32_t mesh_warp_total(const MeshShared& ms, int w) {
  return mesh_popc(ms.ballot[w][0]) | (mesh_popc(ms.ballot[w][1]) << 16);
}

// after part (b)'s first scan: the packed counts of lanes [0, l), l <= L
MT_DEV int32_t mesh_count_at(const MeshShared& ms, int l) {
  const int w = l >> 5, b = l & 31;
  int32_t c = ms.wpre[w];
  if (b) {
    const uint32_t m = (1u << b) - 1;
    c += mesh_popc(ms.ballot[w][0] & m) | (mesh_popc(ms.ballot[w][1] & m) << 16);
  }
  return c;
}

// part (b), lane j of warp 0: shards 2j and 2j + 1 (mesh.py:150-166):
// counts, fair-share target, surplus, deficit capped by free lanes. L is
// the mesh's lanes; with ``gathered`` the counts and their total come
// from gc and total (the cross-card modes), else from the block's ballots.
MT_DEV void mesh_shard_pair(MeshShared& ms, int L, int n, int j, bool gathered = false) {
  const int per = L / n;
  const int total = gathered ? ms.total : mp_run(mesh_count_at(ms, L)), base = total / n, rem = total - base * n;
  int32_t sur = 0, def = 0, lo = 0x7fffffff, hi = -1;
  for (int s = 2 * j; s < 2 * j + 2 && s < n; ++s) {
    int occ, free_;
    if (gathered) {
      occ = ms.gc[2 * s];
      free_ = per - ms.gc[2 * s + 1];
    } else {
      const int32_t c0 = mesh_count_at(ms, s * per), c1 = mesh_count_at(ms, (s + 1) * per);
      occ = mp_run(c1) - mp_run(c0);
      free_ = per - (mp_alive(c1) - mp_alive(c0));
    }
    const int target = base + (s < rem ? 1 : 0);
    const int su = occ > target ? occ - target : 0;
    const int de0 = target > occ ? target - occ : 0;
    const int de = de0 < free_ ? de0 : free_;
    ms.occ[s] = occ;
    ms.alive_c[s] = per - free_;
    ms.surplus[s] = su;
    ms.deficit[s] = de;
    sur += su;
    def += de;
    lo = occ < lo ? occ : lo;
    hi = occ > hi ? occ : hi;
  }
  ms.wv[0][j] = sur;
  ms.wv[1][j] = def;
  ms.wv[2][j] = lo;
  ms.wv[3][j] = hi;
}

// part (b), lane j after the scans of wv: the exclusive cumsums of its
// shards (donor_base, recv_base, recv_end); lane 0 the launch's scalars
MT_DEV void mesh_shard_bases(MeshShared& ms, int L, int n, int flags, int j) {
  int db = ms.wv[0][j], rb = ms.wv[1][j];
  for (int s = 2 * j; s < 2 * j + 2 && s < n; ++s) {
    db -= ms.surplus[s];
    rb -= ms.deficit[s];
  }
  for (int s = 2 * j; s < 2 * j + 2 && s < n; ++s) {
    ms.dbase[s] = db;
    ms.rbase[s] = rb;
    db += ms.surplus[s];
    rb += ms.deficit[s];
    ms.rend[s] = rb;
  }
  if (j) return;
  const int moved = ms.wv[0][31] < ms.wv[1][31] ? ms.wv[0][31] : ms.wv[1][31];
  ms.moved = moved;
  if (flags & MESH_PLAN) {
    ms.go = moved > 0 && (!(flags & MESH_GATE_SPREAD) || ms.wv[3][0] - ms.wv[2][0] > 1);
    ms.nmove = (flags & MESH_MOVE) && ms.go ? moved : 0;
  } else {
    ms.go = 0;
    ms.nmove = (flags & MESH_MOVE) ? mp_run(mesh_count_at(ms, L)) : 0;
  }
}

#ifdef MT_HOST_EMU
// the cross-card modes' total of the gathered running counts
static void mesh_gathered_total(MeshShared& ms, int n) {
  int32_t v = 0;
  for (int s = 0; s < n; ++s) v += ms.gc[2 * s];
  ms.total = v;
}

// part (b)'s warp-collective steps on the host: the same results over
// the arrays, as scan.cuh's rank_scan_warps
static void mesh_warp_counts(MeshShared& ms, int nwarps) {
  int32_t x = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int32_t v = mesh_warp_total(ms, w);
    ms.wpre[w] = x;
    x += v;
  }
  ms.wpre[nwarps] = x;
}

static void mesh_warp_scans(MeshShared& ms) {
  for (int i = 1; i < 32; ++i) {
    ms.wv[0][i] += ms.wv[0][i - 1];
    ms.wv[1][i] += ms.wv[1][i - 1];
  }
  int32_t lo = ms.wv[2][0], hi = ms.wv[3][0];
  for (int i = 1; i < 32; ++i) {
    lo = ms.wv[2][i] < lo ? ms.wv[2][i] : lo;
    hi = ms.wv[3][i] > hi ? ms.wv[3][i] : hi;
  }
  for (int i = 0; i < 32; ++i) ms.wv[2][i] = lo, ms.wv[3][i] = hi;
}
#else
// lane j of warp 0: the cross-card modes' total of the gathered running
// counts (its two shards, summed over the warp)
__device__ __forceinline__ void mesh_gathered_total(MeshShared& ms, int n, int j) {
  int32_t v = 0;
  for (int s = 2 * j; s < 2 * j + 2 && s < n; ++s) v += ms.gc[2 * s];
  v = __reduce_add_sync(0xffffffffu, v);
  if (j == 0) ms.total = v;
}

// lane j of warp 0: the warps' packed counts, exclusive scan by shuffles
__device__ __forceinline__ void mesh_warp_counts(MeshShared& ms, int nwarps, int j) {
  const int32_t v = j < nwarps ? mesh_warp_total(ms, j) : 0;
  int32_t x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (j >= d) x += y;
  }
  if (j < nwarps) ms.wpre[j] = x - v;
  if (j == 31) ms.wpre[nwarps] = x;
}

// lane j of warp 0: inclusive scans of wv[0..1], min of wv[2], max of wv[3]
__device__ __forceinline__ void mesh_warp_scans(MeshShared& ms, int j) {
  int32_t s = ms.wv[0][j], d = ms.wv[1][j], lo = ms.wv[2][j], hi = ms.wv[3][j];
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t ys = __shfl_up_sync(0xffffffffu, s, o), yd = __shfl_up_sync(0xffffffffu, d, o);
    if (j >= o) s += ys, d += yd;
  }
  for (int o = 16; o; o >>= 1) {
    const int32_t yl = __shfl_xor_sync(0xffffffffu, lo, o), yh = __shfl_xor_sync(0xffffffffu, hi, o);
    lo = yl < lo ? yl : lo;
    hi = yh > hi ? yh : hi;
  }
  ms.wv[0][j] = s;
  ms.wv[1][j] = d;
  ms.wv[2][j] = lo;
  ms.wv[3][j] = hi;
}
#endif

// searchsorted(recv_end, gidx, side="right"), clamped to n - 1
MT_DEV int mesh_dest(const MeshShared& ms, int n, int gidx) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ms.rend[mid] <= gidx) lo = mid + 1;
    else hi = mid;
  }
  return lo < n - 1 ? lo : n - 1;
}

// The steal decision and its counters (megakernel.py:401-410).
MT_DEV void mesh_commit(const MeshShared& ms, int flags, int32_t* mctl) {
  mctl[0] = ms.go;
  mctl[1] = ms.moved;
  if (flags & MESH_ACCUM) {
    mctl[2] += ms.go;
    mctl[3] += ms.go ? ms.moved : 0;
  }
}

// part (c), thread t (lane t): the plan of lane t (mesh.py:168-180):
// running lanes ranked at or past keep export, to global donor index
// gidx; dest is the shard whose [recv_base, recv_end) holds gidx, slot
// the offset in it; buf_pos = dest * per + slot, n * per when not
// exported. The exporter's row lands at lane alive_c[dest] + slot of
// block dest (mesh.py:216-222), so move gidx is (lane, that lane). From
// a given plan, move k is the k-th exported lane. Block 0 (writer) writes
// the plan, and threads below n the shard columns.
MT_DEV void mesh_lane_plan(MeshShared& ms, int L, int n, int flags, bool writer, uint8_t* export_,
                           int32_t* buf_pos, int32_t* sh, int32_t* mctl, int t) {
  const int per = L / n;
  const bool from_plan = (flags & MESH_MOVE) && !(flags & MESH_PLAN);
  if (writer && !from_plan && t < n) {
    sh[t] = ms.occ[t];
    sh[n + t] = ms.alive_c[t];
    if (flags & MESH_PLAN) {
      const int f = ms.moved - ms.rbase[t];
      sh[2 * n + t] = f < 0 ? 0 : (f > ms.deficit[t] ? ms.deficit[t] : f);
    }
  }
  if (writer && (flags & MESH_PLAN) && t == 0) mesh_commit(ms, flags, mctl);
  if (t >= L || !(flags & (MESH_PLAN | MESH_MOVE))) return;
  const bool bit = (ms.ballot[t >> 5][0] >> (t & 31)) & 1;
  if (from_plan) {
    if (!bit) return;
    const int k = mp_run(mesh_count_at(ms, t)), pos = buf_pos[t], dest = pos / per;
    ms.mv_src[k] = (int16_t)t;
    ms.mv_dst[k] = (int16_t)(dest * per + sh[n + dest] + (pos - dest * per));
    return;
  }
  const int s = t / per;
  const int rank = mp_run(mesh_count_at(ms, t)) - mp_run(mesh_count_at(ms, s * per));
  const int keep = ms.occ[s] - ms.surplus[s], gidx = ms.dbase[s] + rank - keep;
  const bool ex = bit && rank >= keep && gidx < ms.moved;
  int pos = n * per;
  if (ex) {
    const int dest = mesh_dest(ms, n, gidx), slot = gidx - ms.rbase[dest];
    pos = dest * per + slot;
    if (ms.nmove) {
      ms.mv_src[gidx] = (int16_t)t;
      ms.mv_dst[gidx] = (int16_t)(dest * per + ms.alive_c[dest] + slot);
    }
  }
  if (writer) {
    export_[t] = ex ? 1 : 0;
    buf_pos[t] = pos;
  }
}

// the plane that holds unit v of a row: the last f with ustart[f] <= v
MT_DEV int mesh_field_of(const MeshShared& ms, int v) {
  int lo = 0, hi = NFIELDS - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ms.ustart[mid] <= v) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// what mesh_move_units copies: the steal's moves (exporter row to target
// row, or to a row of the card's send batch, the exporter's MESH_KILLED
// planes zeroed), the deal's two halves (moving row m to scratch row m;
// scratch row m to its slot), or the cross-card pull (a row of another
// card's send batch to its target lane)
enum MeshMoveDir { MESH_STEAL_MOVES, MESH_TO_SCRATCH, MESH_FROM_SCRATCH, MESH_FROM_PEERS };

// part (d), thread gtid of the grid's G: units gtid, gtid + G, ... of the
// nmove moved rows (unit u: move u / U, unit u % U of the row), each
// copied from its source row to its target row (dir), MESH_BATCH of them
// loaded before any is stored. The kill (mesh.py:210-215) cannot overtake
// the copy of the same bytes: the thread that copies a unit of a
// MESH_KILLED plane then stores zeros over it at the source, after its
// own load of it. Exporters are alive and targets free, so no two moves
// touch one lane and every byte is written by one thread; the deal's
// slots are a permutation, its scratch rows distinct.
MT_DEV void mesh_move_units(const MeshShared& ms, uint32_t gtid, uint32_t G, int dir = MESH_STEAL_MOVES) {
  const uint32_t U = (uint32_t)ms.ustart[NFIELDS], total = (uint32_t)ms.nmove * U;
  const mt_u4 z = {0, 0, 0, 0};
  for (uint32_t u0 = gtid; u0 < total; u0 += MESH_BATCH * G) {
    mt_u4 buf[MESH_BATCH];
    uint8_t* src[MESH_BATCH];
    uint8_t* dst[MESH_BATCH];
    int sft[MESH_BATCH];
    bool kill[MESH_BATCH];
#pragma unroll
    for (int k = 0; k < MESH_BATCH; ++k) {
      const uint32_t u = u0 + k * G;
      dst[k] = nullptr;
      src[k] = nullptr;
      sft[k] = 0;
      kill[k] = false;
      buf[k] = z;
      if (u >= total) continue;
      const uint32_t m = u / U, v = u - m * U;
      if (dir == MESH_FROM_PEERS && ms.mv_card[m] < 0) continue;
      const int f = mesh_field_of(ms, (int)v);
      sft[k] = ms.ushift[f];
      kill[k] = dir == MESH_STEAL_MOVES && ((MESH_KILLED >> f) & 1);
      const int64_t off = (int64_t)(v - (uint32_t)ms.ustart[f]) << sft[k];
      if (dir == MESH_FROM_PEERS) {
        src[k] = (uint8_t*)ms.peers->send[ms.mv_card[m]][f] + ms.rb[f] * ms.mv_src[m] + off;
        dst[k] = ms.base[f] + ms.rb[f] * ms.mv_dst[m] + off;
      } else {
        uint8_t* scr = dir == MESH_STEAL_MOVES ? nullptr : ms.sbase[f] + ms.rb[f] * m + off;
        src[k] = dir == MESH_FROM_SCRATCH ? scr : ms.base[f] + ms.rb[f] * ms.mv_src[m] + off;
        const int dl = ms.mv_dst[m];
        dst[k] = dir == MESH_TO_SCRATCH ? scr
                 : dl < 0               ? ms.sbase[f] + ms.rb[f] * (-1 - dl) + off
                                        : ms.base[f] + ms.rb[f] * dl + off;
      }
      if (sft[k] == 4) buf[k] = *(const mt_u4*)src[k];
      else if (sft[k] == 2) buf[k].x = *(const uint32_t*)src[k];
      else buf[k].x = *src[k];
    }
#pragma unroll
    for (int k = 0; k < MESH_BATCH; ++k) {
      if (!dst[k]) continue;
      if (sft[k] == 4) *(mt_u4*)dst[k] = buf[k];
      else if (sft[k] == 2) *(uint32_t*)dst[k] = buf[k].x;
      else *dst[k] = (uint8_t)buf[k].x;
      if (!kill[k]) continue;
      if (sft[k] == 4) *(mt_u4*)src[k] = z;
      else if (sft[k] == 2) *(uint32_t*)src[k] = 0u;
      else *src[k] = 0;
    }
  }
}

// K12 (mesh.py:83-110 rebalance), part (c) and (e), thread t (lane t):
// lane t's slot. Its packed place p (the running lanes first, each part
// in lane order) is its count of running lanes before it, or past the
// running lanes its count of idle ones; slot s * per + k takes packed
// place k * n + s. Lanes past L keep their own (they do not move).
MT_DEV int mesh_deal_slot(const MeshShared& ms, int L, int n, int t) {
  if (t >= L) return t;
  const int before = mp_run(mesh_count_at(ms, t)), total = mp_run(mesh_count_at(ms, L));
  const int p = (ms.ballot[t >> 5][0] >> (t & 31)) & 1 ? before : total + t - before;
  return (p % n) * (L / n) + p / n;
}

// K12 part (e), thread t, after the second scan (its bits 16-31 count
// the moving lanes): block 0 (writer) writes order[slot] = t; a lane that
// moves records move m (its rank among the moving lanes): source lane t,
// scratch row m, target lane slot. Thread 0 sets the move count.
MT_DEV void mesh_deal_record(MeshShared& ms, int L, int n, bool writer, int32_t* order, int t) {
  if (t == 0) ms.nmove = mp_alive(mesh_count_at(ms, L));
  if (t >= L) return;
  const int slot = mesh_deal_slot(ms, L, n, t);
  if (writer) order[slot] = t;
  if (slot == t) return;
  const int m = mp_alive(mesh_count_at(ms, t));
  ms.mv_src[m] = (int16_t)t;
  ms.mv_dst[m] = (int16_t)slot;
}

// -- the cross-card exchange (mesh_cards_kernel) ------------------------

// XC_COUNT, thread t after warp 0's scan of the card's ballots: pair t =
// (card k, own shard s) stores own shard s's [running, alive] at shard
// card * nl + s of card k's gathered buffer.
MT_DEV void mesh_card_counts(const MeshShared& ms, const CardPeers& X, int per, int nl, int card, int cards,
                             int t) {
  if (t >= nl * cards) return;
  const int k = t / nl, s = t - k * nl;
  const int32_t c0 = mesh_count_at(ms, s * per), c1 = mesh_count_at(ms, (s + 1) * per);
  int32_t* g = X.gath[k] + 2 * (card * nl + s);
  g[0] = mp_run(c1) - mp_run(c0);
  g[1] = mp_alive(c1) - mp_alive(c0);
}

// XC_PLAN and XC_PULL, thread 0 after part (b): the card's run of moves.
// XC_PLAN moves the card's exports, global donor indices [lo, lo +
// nmove); XC_PULL its imports, global receiver indices [lo, lo + nmove)
// (lo into ms.lo).
// Both are empty unless the plan says steal (go).
MT_DEV void mesh_card_run(MeshShared& ms, int nl, int card, int mode) {
  const int s0 = card * nl, s1 = s0 + nl - 1;
  const int lo = mode == XC_PLAN ? ms.dbase[s0] : ms.rbase[s0];
  const int hi = mode == XC_PLAN ? ms.dbase[s1] + ms.surplus[s1] : ms.rend[s1];
  const int k = (ms.moved < hi ? ms.moved : hi) - lo;
  ms.nmove = ms.go && k > 0 ? k : 0;
  ms.lo = lo;
}

// XC_PLAN part (c), thread t (the card's lane t): lane t's export, as
// mesh_lane_plan ranks it (its rank among its shard's running lanes from
// the card's ballots; the shard scalars from the gathered counts). Move
// m = gidx - lo: to lane alive_c[dest] + slot of dest's block when dest
// is one of the card's shards, else to row m of the card's send batch.
MT_DEV void mesh_card_lane_plan(MeshShared& ms, int per, int n, int nl, int card, int t) {
  if (t >= nl * per || !ms.nmove || !((ms.ballot[t >> 5][0] >> (t & 31)) & 1)) return;
  const int sl = t / per, s = card * nl + sl;
  const int rank = mp_run(mesh_count_at(ms, t)) - mp_run(mesh_count_at(ms, sl * per));
  const int keep = ms.occ[s] - ms.surplus[s], gidx = ms.dbase[s] + rank - keep;
  if (rank < keep || gidx >= ms.moved) return;
  const int dest = mesh_dest(ms, n, gidx), slot = gidx - ms.rbase[dest], m = gidx - ms.lo;
  ms.mv_src[m] = (int16_t)t;
  ms.mv_dst[m] = (int16_t)(dest / nl == card ? (dest - card * nl) * per + ms.alive_c[dest] + slot : -1 - m);
}

// XC_PULL, thread i: import i of the card, global index gidx = lo + i:
// its target lane alive_c[dest] + slot of dest's block, its donor shard
// the first d with donor_base[d] + surplus[d] > gidx, and its row in the
// donor card's send batch gidx - donor_base[donor card's first shard].
// An import from one of the card's own shards was placed by XC_PLAN.
MT_DEV void mesh_card_pull_plan(MeshShared& ms, int per, int n, int nl, int card, int i) {
  if (i >= ms.nmove) return;
  const int gidx = ms.lo + i;
  const int dest = mesh_dest(ms, n, gidx), slot = gidx - ms.rbase[dest];
  int a = 0, b = n;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (ms.dbase[mid] + ms.surplus[mid] <= gidx) a = mid + 1;
    else b = mid;
  }
  const int dc = a / nl;
  ms.mv_card[i] = (int8_t)(dc == card ? -1 : dc);
  ms.mv_src[i] = (int16_t)(gidx - ms.dbase[dc * nl]);
  ms.mv_dst[i] = (int16_t)((dest - card * nl) * per + ms.alive_c[dest] + slot);
}

// XC_PLAN, block 0's thread 0 after part (b): the steal decision and its
// counters into mctl, the gathered counts into held (XC_PULL's input),
// and, in the fused loop (ctl), the staged continue bit from the
// mesh-wide running total: ctl[2] is the round K4 staged.
MT_DEV void mesh_card_commit(const MeshShared& ms, int n, int32_t* held, int32_t* mctl, int32_t* ctl,
                             int max_rounds) {
  mesh_commit(ms, MESH_STEAL_ROUND_FLAGS, mctl);
  for (int i = 0; i < 2 * n; ++i) held[i] = ms.gc[i];
  if (ctl) ctl[3] = ctl[2] < max_rounds && ms.total > 0 ? 1 : 0;
}
