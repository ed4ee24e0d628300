// K10/K11 mesh_steal and K12 mesh_deal: the mesh tiers on one card, where
// the mesh is n contiguous lane blocks of one batch (mesh.cuh); and
// mesh_cards_kernel, the fused loop's steal when the shards lie on
// several cards (the cross-card exchange, further down).
//
// mesh_steal_kernel is K10 and K11 in one kernel (replaces
// mythril_tpu/laser/tpu/mesh.py:127 steal_plan with :237 occupancy_impl,
// :178 steal_apply, and the gate and counters of megakernel.py:401-410),
// one cooperative launch a use: the fused mesh loop's steal round (plan,
// decide, move under the gate, count) and the standalone occupancy_impl,
// steal_plan and steal_apply (flags, mesh.cuh). The parts of a launch are
// in mesh.cuh: (a) a thread a lane and two ballots a warp; (b) warp 0's
// scans of the warps' counts and of the shards' scalars; (c) a thread a
// lane ranks, searches and records its move; (d) the grid shares the
// moved rows' units. Each block plans from the unchanged planes on its
// own (the plan reads 5 bytes a lane), so all blocks reach the same
// decision: when it is "no steal" they all return after (c), and the
// launch has written only the plan and mctl. Two hazards:
//  - counts against moves: the plan reads the alive and status planes
//    of every lane, target lanes included, and the moves write them. So
//    a launch that plans and moves meets at one grid barrier between (c)
//    and (d): no block writes a plane before every block has read its
//    inputs. All blocks decide alike, so all reach it or none does. A
//    launch that moves from a given plan reads no plane before its moves
//    (its bits are export_'s), so it has no barrier.
//  - copy against kill: the exporter's alive, steps, static_pruned and
//    visited are zeroed by the thread that copied each unit of them, after
//    its own load (mesh_move_units).
// Only counting and planning launch one block (no moves to share); the
// moving uses launch as many blocks as the card holds at once (a
// cooperative launch must be resident as a whole).
//
// Bound on the H100: bytes. The plan reads 5 bytes a lane (alive,
// status) and writes 5 a lane of plan (export_, buf_pos) with 12 n + 16
// of shard columns and mctl; the moves read each moved row once and
// write it once (and zero the exporters' killed planes). At L = 512 that
// is under 10 KB without a steal, so the launch is launch- and
// latency-bound: the design keeps it to one launch a round with four
// block barriers and no serial walk (one load a thread, ballots,
// two warp scans of 32 lanes, a binary search of 6 steps), and spreads a
// steal's rows over every SM in 16-byte units where the planes allow,
// MESH_BATCH loads in flight a thread, so a steal's time follows its bytes.
//
// mesh_deal_kernel is K12 (replaces mesh.py:83 rebalance): one
// cooperative launch a deal, of the card's resident blocks (sized by
// mesh_resident_blocks, as the steal kernel's), in place on the batch.
// Each block orders the deal from the unchanged planes on its own, a
// thread a lane: the running bits' ballots and warp 0's scan (parts (a)
// and (b) of mesh.cuh, the steal kernel's), each lane's packed place and
// slot, a second ballot and scan of the lanes whose slot is not their
// own, and each such lane's rank among them, which is its scratch row;
// block 0 writes order. A deal where no lane moves (all running lanes
// already dealt) returns there, having written only order. Otherwise the
// grid copies the moving rows' units into the scratch batch (16, 4 or 1
// bytes, MESH_BATCH loads in flight a thread, mesh_move_units), meets at
// one grid barrier, and copies them from there into their slots. Rows
// that stay put are never read or written. One grid barrier is enough:
// the plan's reads of alive and status and the gather's reads of the
// planes all come before it, and the only writes to a plane after it.
// The scratch holds one row per moving lane (at most L); kernels.py
// keeps one per batch shape. mesh.rebalance, pure as the reference's,
// clones the batch and deals the clone; the sync mesh round deals the
// copy engine.run returned.
//
// Bound on the H100: bytes. The plan reads 5 bytes a lane and order
// writes 4; the deal moves D rows of rb bytes, so the bound is
// 2 D rb + 9 L bytes. Going through the scratch reads and writes each
// moved row twice (4 D rb), so the design reaches at most half its
// bound; a deal in place without scratch would have to follow the
// permutation's cycles.
#include <cooperative_groups.h>

#include "mesh.cuh"

namespace cg = cooperative_groups;

#define MESH_THREADS MESH_MAX_LANES
#define MAX_DEVICES 64

__global__ void __launch_bounds__(MESH_THREADS, 1)
    mesh_steal_kernel(Planes P, int n, int flags, uint8_t* export_, int32_t* buf_pos, int32_t* sh,
                      int32_t* mctl, const int32_t* ctl) {
  if (ctl && !ctl[1]) return;
  __shared__ MeshShared ms;
  const int t = threadIdx.x, L = P.L;
  // (a)
  mesh_unit_fields(P, ms, t, blockDim.x);
  const uint8_t b = mesh_lane_bits(P, export_, flags, t);
  const uint32_t b0 = __ballot_sync(0xffffffffu, b & 1), b1 = __ballot_sync(0xffffffffu, b & 2);
  if ((t & 31) == 0) {
    ms.ballot[t >> 5][0] = b0;
    ms.ballot[t >> 5][1] = b1;
  }
  __syncthreads();
  // (b); warp 1 sums the unit table meanwhile
  if (t == 32) mesh_units_prefix(ms);
  if (t < 32) {
    mesh_warp_counts(ms, blockDim.x >> 5, t);
    __syncwarp();
    mesh_shard_pair(ms, L, n, t);
    __syncwarp();
    mesh_warp_scans(ms, t);
    __syncwarp();
    mesh_shard_bases(ms, L, n, flags, t);
  }
  __syncthreads();
  // (c)
  mesh_lane_plan(ms, L, n, flags, blockIdx.x == 0, export_, buf_pos, sh, mctl, t);
  __syncthreads();
  if (!ms.nmove) return;
  if (flags & MESH_PLAN) cg::this_grid().sync();  // counts against moves
  // (d)
  mesh_move_units(ms, blockIdx.x * blockDim.x + t, gridDim.x * blockDim.x);
}

// The most blocks of ``kernel`` (of MESH_THREADS threads) the current
// device holds at once; ``cache`` holds one count a device.
static int mesh_resident_blocks(const void* kernel, int* cache, int* out) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return (int)e;
  if (dev < MAX_DEVICES && cache[dev]) {
    *out = cache[dev];
    return 0;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MESH_THREADS, 0);
  if (e) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e) return (int)e;
  *out = per_sm * sms;
  if (dev < MAX_DEVICES) cache[dev] = *out;
  return 0;
}

__global__ void __launch_bounds__(MESH_THREADS, 1)
    mesh_deal_kernel(Planes P, const __grid_constant__ Planes Sc, int n, int32_t* order) {
  __shared__ MeshShared ms;
  const int t = threadIdx.x, L = P.L, nwarps = blockDim.x >> 5;
  // (a) the running bits
  mesh_unit_fields(P, ms, t, blockDim.x, &Sc);
  const uint32_t run = __ballot_sync(0xffffffffu, mesh_lane_bits(P, nullptr, MESH_PLAN, t) & 1);
  if ((t & 31) == 0) {
    ms.ballot[t >> 5][0] = run;
    ms.ballot[t >> 5][1] = 0;
  }
  __syncthreads();
  // (b) warp 0 scans them; warp 1 sums the unit table meanwhile
  if (t == 32) mesh_units_prefix(ms);
  if (t < 32) mesh_warp_counts(ms, nwarps, t);
  __syncthreads();
  // (c) the lanes that move
  const uint32_t mv = __ballot_sync(0xffffffffu, mesh_deal_slot(ms, L, n, t) != t);
  if ((t & 31) == 0) ms.ballot[t >> 5][1] = mv;
  __syncthreads();
  // (d) warp 0 scans them
  if (t < 32) mesh_warp_counts(ms, nwarps, t);
  __syncthreads();
  // (e) order and the moves
  mesh_deal_record(ms, L, n, blockIdx.x == 0, order, t);
  __syncthreads();
  if (!ms.nmove) return;
  const uint32_t gtid = blockIdx.x * blockDim.x + t, G = gridDim.x * blockDim.x;
  mesh_move_units(ms, gtid, G, MESH_TO_SCRATCH);
  cg::this_grid().sync();  // every gather (and every plan) before any row lands in its slot
  mesh_move_units(ms, gtid, G, MESH_FROM_SCRATCH);
}

// The cross-card exchange (mesh.cuh): one kernel in three modes, each one
// cooperative launch on each card (XC_COUNT one block; XC_PLAN and XC_PULL
// the card's resident blocks), on the card's own stream and under its
// device. X holds every card's gathered buffer and send batch; on real
// cards those are peer pointers (mt_mesh_enable_peers), on virtual cards
// of one device local ones. XC_COUNT stores the card's counts into every
// card's gathered buffer; XC_PLAN plans from the card's own gathered
// buffer, moves its exporters (in place, or into its send batch Sd) and
// holds the counts; XC_PULL plans from the held counts and copies the
// card's imports out of the donors' send batches. Only XC_PLAN reads a
// plane that its moves write (the running bits), so only it meets at a
// grid barrier between plan and moves; XC_PULL's plan reads no plane and
// its moves write only free lanes. The host orders the modes across
// cards with events (megakernel.run_fused_mesh).
//
// Bound on the H100: bytes. XC_COUNT reads 5 bytes a lane of the card and
// stores 8 bytes a shard to each card; XC_PLAN reads 5 bytes a lane and
// 8 n of counts and moves each exported row once (read, written to its
// target or send row); XC_PULL reads 8 n and moves each imported row
// once, across the link on real cards.
__global__ void __launch_bounds__(MESH_THREADS, 1)
    mesh_cards_kernel(Planes P, const __grid_constant__ Planes Sd, const __grid_constant__ CardPeers X, int n,
                      int card, int cards, int mode, int32_t* held, int32_t* mctl, int32_t* ctl, int max_rounds) {
  if (ctl && !ctl[1]) return;
  __shared__ MeshShared ms;
  const int t = threadIdx.x, nl = n / cards, per = P.L / nl;
  // (a) the card's lanes; the counts the plan starts from
  mesh_unit_fields(P, ms, t, blockDim.x, &Sd);
  if (mode != XC_PULL) {
    const uint8_t b = mesh_lane_bits(P, nullptr, MESH_PLAN, t);
    const uint32_t b0 = __ballot_sync(0xffffffffu, b & 1), b1 = __ballot_sync(0xffffffffu, b & 2);
    if ((t & 31) == 0) {
      ms.ballot[t >> 5][0] = b0;
      ms.ballot[t >> 5][1] = b1;
    }
  }
  if (mode != XC_COUNT)
    for (int i = t; i < 2 * n; i += blockDim.x) ms.gc[i] = mode == XC_PLAN ? X.gath[card][i] : held[i];
  if (t == 0) ms.peers = &X;
  __syncthreads();
  if (mode == XC_COUNT) {
    if (t < 32) mesh_warp_counts(ms, blockDim.x >> 5, t);
    __syncthreads();
    mesh_card_counts(ms, X, per, nl, card, cards, t);
    return;
  }
  // (b) the shard scalars from the gathered counts; warp 1 sums the unit table meanwhile
  if (t == 32) mesh_units_prefix(ms);
  if (t < 32) {
    if (mode == XC_PLAN) mesh_warp_counts(ms, blockDim.x >> 5, t);
    mesh_gathered_total(ms, n, t);
    __syncwarp();
    mesh_shard_pair(ms, n * per, n, t, true);
    __syncwarp();
    mesh_warp_scans(ms, t);
    __syncwarp();
    mesh_shard_bases(ms, n * per, n, MESH_STEAL_ROUND_FLAGS, t);
    __syncwarp();
    if (t == 0) mesh_card_run(ms, nl, card, mode);
  }
  __syncthreads();
  const uint32_t gtid = blockIdx.x * blockDim.x + t, G = gridDim.x * blockDim.x;
  if (mode == XC_PLAN) {
    // (c)
    if (blockIdx.x == 0 && t == 0) mesh_card_commit(ms, n, held, mctl, ctl, max_rounds);
    mesh_card_lane_plan(ms, per, n, nl, card, t);
    __syncthreads();
    if (!ms.nmove) return;
    cg::this_grid().sync();  // counts against moves
    // (d)
    mesh_move_units(ms, gtid, G, MESH_STEAL_MOVES);
    return;
  }
  mesh_card_pull_plan(ms, per, n, nl, card, t);
  __syncthreads();
  if (!ms.nmove) return;
  mesh_move_units(ms, gtid, G, MESH_FROM_PEERS);
}

// kernel launches made by this library: the steal kernel's, the deal's,
// the cross-card exchange's
static long long mesh_kernel_launches[3];

static int mesh_args_ok(const Planes* P, int n, int nfields) {
  if (nfields != NFIELDS) return 0;
  if (P->L <= 0 || P->L > MESH_MAX_LANES) return 0;
  return n >= 1 && n <= MESH_MAX_SHARDS && P->L % n == 0;
}

MT_ERROR_STRING_FN

// One launch of the steal kernel under flags (mesh.cuh). export_ u8[L],
// buf_pos i32[L], sh i32[3n], mctl i32[4]; ctl (the fused loop's control
// word, or null): the launch does nothing once ctl[1] is 0.
MT_EXPORT int mt_mesh_steal(const Planes* P, int n, int flags, uint8_t* export_, int32_t* buf_pos,
                            int32_t* sh, int32_t* mctl, const int32_t* ctl, int nfields, cudaStream_t stream) {
  if (!mesh_args_ok(P, n, nfields)) return (int)cudaErrorInvalidValue;
  int grid = 1;
  if (flags & MESH_MOVE) {
    static int cache[MAX_DEVICES];
    int err = mesh_resident_blocks((const void*)mesh_steal_kernel, cache, &grid);
    if (err) return err;
    if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  Planes Pv = *P;
  void* args[] = {&Pv, &n, &flags, (void*)&export_, (void*)&buf_pos, (void*)&sh, (void*)&mctl, (void*)&ctl};
  int err = (int)cudaLaunchCooperativeKernel((const void*)mesh_steal_kernel, dim3(grid), dim3(MESH_THREADS), args,
                                             0, stream);
  if (err) {
    cudaGetLastError();  // leave no error behind for the next launch's check
    return err;
  }
  ++mesh_kernel_launches[0];
  return (int)cudaGetLastError();
}

// out = [registers per thread, local bytes per thread (spills and stack),
// static shared bytes per block, threads per block, blocks resident per
// SM, SMs] of the steal kernel (which 0), the deal (which 1) or the
// cross-card exchange (which 2): what chip_smoke.py prints beside their
// times.
MT_EXPORT int mt_mesh_info(int* out, int which) {
  const void* kernel = which == 2 ? (const void*)mesh_cards_kernel
                       : which    ? (const void*)mesh_deal_kernel
                                  : (const void*)mesh_steal_kernel;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e) return (int)e;
  int dev, per_sm = 0, sms = 0;
  if ((e = cudaGetDevice(&dev))) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MESH_THREADS, 0))) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = MESH_THREADS;
  out[4] = per_sm;
  out[5] = sms;
  return 0;
}

// K12: one cooperative launch deals the batch P in place over n shards,
// the moving rows through the scratch batch Sc (planes of P's row sizes
// and at least P's lanes); order i32[L] gets the deal's lane order.
MT_EXPORT int mt_mesh_deal(const Planes* P, const Planes* Sc, int n, int32_t* order, int nfields,
                           cudaStream_t stream) {
  if (!mesh_args_ok(P, n, nfields) || Sc->L < P->L) return (int)cudaErrorInvalidValue;
  for (int f = 0; f < NFIELDS; ++f)
    if (Sc->row_bytes[f] != P->row_bytes[f]) return (int)cudaErrorInvalidValue;
  static int cache[MAX_DEVICES];
  int grid = 0;
  int err = mesh_resident_blocks((const void*)mesh_deal_kernel, cache, &grid);
  if (err) return err;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  Planes Pv = *P, Sv = *Sc;
  void* args[] = {&Pv, &Sv, &n, (void*)&order};
  err = (int)cudaLaunchCooperativeKernel((const void*)mesh_deal_kernel, dim3(grid), dim3(MESH_THREADS), args, 0,
                                         stream);
  if (err) {
    cudaGetLastError();
    return err;
  }
  ++mesh_kernel_launches[1];
  return (int)cudaGetLastError();
}

// One launch of the cross-card exchange on card ``card`` of ``cards`` (the
// current device must be that card's): P the card's batch (n / cards
// shards), Sd its send batch (P's row sizes, at least P's lanes), X every
// card's buffers, held i32[2n], mctl i32[4]; ctl (the fused loop's control
// word, or null): the launch does nothing once ctl[1] is 0.
MT_EXPORT int mt_mesh_cards(const Planes* P, const Planes* Sd, const CardPeers* X, int n, int card, int cards,
                            int mode, int32_t* held, int32_t* mctl, int32_t* ctl, int max_rounds, int nfields,
                            cudaStream_t stream) {
  if (cards < 1 || cards > MESH_MAX_CARDS || card < 0 || card >= cards || n % cards) return (int)cudaErrorInvalidValue;
  const int nl = n / cards;
  if (nfields != NFIELDS || n > MESH_MAX_SHARDS || P->L <= 0 || P->L > MESH_MAX_LANES || P->L % nl) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode < XC_COUNT || mode > XC_PULL || Sd->L < P->L) return (int)cudaErrorInvalidValue;
  for (int f = 0; f < NFIELDS; ++f)
    if (Sd->row_bytes[f] != P->row_bytes[f]) return (int)cudaErrorInvalidValue;
  int grid = 1;
  if (mode != XC_COUNT) {
    static int cache[MAX_DEVICES];
    int err = mesh_resident_blocks((const void*)mesh_cards_kernel, cache, &grid);
    if (err) return err;
    if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  Planes Pv = *P, Sv = *Sd;
  CardPeers Xv = *X;
  void* args[] = {&Pv, &Sv, &Xv, &n, &card, &cards, &mode, (void*)&held, (void*)&mctl, (void*)&ctl, &max_rounds};
  int err = (int)cudaLaunchCooperativeKernel((const void*)mesh_cards_kernel, dim3(grid), dim3(MESH_THREADS), args,
                                             0, stream);
  if (err) {
    cudaGetLastError();
    return err;
  }
  ++mesh_kernel_launches[2];
  return (int)cudaGetLastError();
}

// Lets each of the k devices in devs read and write the others' memory.
// Fails with cudaErrorPeerAccessUnsupported where a pair of distinct
// cards cannot reach each other; a device listed twice needs nothing.
MT_EXPORT int mt_mesh_enable_peers(const int* devs, int k) {
  int cur;
  cudaError_t e = cudaGetDevice(&cur);
  if (e) return (int)e;
  for (int i = 0; i < k; ++i) {
    for (int j = 0; j < k; ++j) {
      if (devs[i] == devs[j]) continue;
      int ok = 0;
      if ((e = cudaDeviceCanAccessPeer(&ok, devs[i], devs[j]))) return (int)e;
      if (!ok) return (int)cudaErrorPeerAccessUnsupported;
      if ((e = cudaSetDevice(devs[i]))) return (int)e;
      e = cudaDeviceEnablePeerAccess(devs[j], 0);
      if (e == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();
      } else if (e) {
        cudaSetDevice(cur);
        return (int)e;
      }
    }
  }
  return (int)cudaSetDevice(cur);
}

// out = [steal kernel launches, deal kernel launches, cross-card exchange
// launches] made so far
MT_EXPORT int mt_mesh_launches(long long* out) {
  out[0] = mesh_kernel_launches[0];
  out[1] = mesh_kernel_launches[1];
  out[2] = mesh_kernel_launches[2];
  return 0;
}
