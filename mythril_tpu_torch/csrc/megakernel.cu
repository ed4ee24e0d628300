// K4: the fused round's epilogue (replaces the tail of
// mythril_tpu/laser/tpu/megakernel.py:134 _one_round: prune_mask :113,
// the in-loop kill, the counter folds, pruned_visited, compact_impl :121;
// the loop is megakernel.py:204 _fused_impl). One cooperative launch:
//  (1) plan: each thread takes at most ceil(L / grid threads) lanes and
//      writes their flags (dies, survives, runs on) to scratch; the folds
//      are u32 sums, reduced by warp shuffles and added to acc with one
//      atomic per block and field; grid.sync();
//  (2) every block scans all the flags in its own shared memory
//      (scan.cuh, as K1's fork rank), so each knows every lane's place:
//      survivors first, each group in lane order, inside each of the
//      n_shards contiguous lane blocks. The row that moves into each
//      destination goes to scratch (a destination whose source is itself
//      copies nothing), and a dying source's visited row is OR-ed into
//      pruned_visited; grid.sync();
//  (3) the moved rows come back from scratch, and every dying lane's
//      counters and visited row are zeroed where it now lies, moved or
//      not; block 0 commits the staged control word (EPI_COMMIT).
// In (2) and (3) the grid's warps split the L rows evenly, several warps
// a row, and a row is one list of units over all its planes (16, 4 or 1
// bytes each) of which each thread loads EPI_BATCH before it stores any,
// so that enough loads are in flight to keep the memory busy whatever the
// planes' sizes: the grid is EPI_ROW_WARPS warps a lane, at most what the
// card holds at once (a cooperative launch must be resident as a whole).
// Every block reads ctl and the gate word (K10's; nothing runs while it
// is 0, only the commit) once at entry: nothing in the launch writes them
// before the last barrier, so every block takes the same branch and
// reaches the same grid.sync()s. EPI_COMPACT_ONLY is the bare per-shard
// compaction after a steal: no prune, kill, folds or staging.
//
// Bound on the H100: bytes. The per-lane flag planes read once and the
// order and dying mask written once, plus 2 x the rows that move (read
// and written) and 2 x code_len per dying lane (its visited row read,
// and zeroed). The design moves only the rows that move (4 x their bytes,
// through scratch; a dying row's visited plane is not moved but zeroed)
// and has no serial walk over the lanes; at the main path's shapes the
// two grid barriers and the rows' copies set its time.
#include <cooperative_groups.h>

#include "megakernel.cuh"

namespace cg = cooperative_groups;

#define EPI_THREADS 128
#define EPI_ROW_WARPS 4
#define MAX_DEVICES 64

__device__ __forceinline__ void epi_fold_block(uint32_t f[4], EpiShared& sh, int32_t* acc, int tid,
                                               int nthreads) {
  for (int k = 0; k < 4; ++k)
    for (int o = 16; o; o >>= 1) f[k] += __shfl_down_sync(0xffffffffu, f[k], o);
  if ((tid & 31) == 0)
    for (int k = 0; k < 4; ++k) sh.fold[tid >> 5][k] = f[k];
  __syncthreads();
  if (tid < 4) {
    uint32_t s = 0;
    for (int w = 0; w < nthreads / 32; ++w) s += sh.fold[w][tid];
    if (s) atomicAdd((unsigned int*)acc + tid, s);
  }
}

__global__ void __launch_bounds__(EPI_THREADS)
    epilogue_kernel(Planes P, Planes Sc, const uint8_t* prune_revert, const uint8_t* unsat, int32_t* acc,
                    int32_t* order, uint8_t* dying, uint8_t* lflags, uint8_t* pv, int32_t* ctl,
                    int max_rounds, int n_shards, int flags, const int32_t* gate) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (!ctl[1]) return;
  if (gate && !gate[0]) {
    if (blockIdx.x == 0 && tid == 0 && (flags & EPI_COMMIT)) epi_commit(ctl);
    return;
  }
  cg::grid_group grid = cg::this_grid();
  __shared__ EpiShared sh;
  const bool compact_only = flags & EPI_COMPACT_ONLY;
  const int L = P.L, per = L / n_shards, wl = tid & 31;
  const int gtid = blockIdx.x * nt + tid, gthreads = gridDim.x * nt;
  const int gwarp = blockIdx.x * (nt / 32) + (tid >> 5), nwarps = gridDim.x * (nt / 32);
  // (0) the unit table, read from part 2 on, after the scan's barriers
  epi_units_fields(P, Sc, sh, tid, nt);
  __syncthreads();
  if (tid == 0) epi_units_prefix(sh);
  // (1)
  uint32_t fold[4];
  epi_plan_lanes(P, prune_revert, unsat, lflags, dying, compact_only, gtid, gthreads, fold);
  if (!compact_only) epi_fold_block(fold, sh, acc, tid, nt);
  grid.sync();
  // (2)
  rank_sum_chunk(L, lflags, sh.rs, tid, nt);
  __syncthreads();
  rank_scan_warp(sh.rs, tid);
  __syncthreads();
  rank_prefix(L, lflags, sh.rs, tid, nt);
  __syncthreads();
  epi_scatter(L, per, lflags, sh, tid, nt);
  __syncthreads();
  for (int d = gtid; d < L; d += gthreads) order[d] = sh.src_of[d];
  if (blockIdx.x == 0 && tid == 0 && !compact_only) epi_stage_ctl(sh.rs, L, ctl, max_rounds);
  const int wpr = nwarps >= L ? nwarps / L : 1;
  for (int u = gwarp; u < L * wpr; u += nwarps)
    epi_gather_unit(P, lflags, sh, pv, u / wpr, (u % wpr) * 32 + wl, wpr * 32);
  grid.sync();
  // (3)
  for (int u = gwarp; u < L * wpr; u += nwarps)
    epi_place_unit(lflags, sh, u / wpr, (u % wpr) * 32 + wl, wpr * 32);
  if (blockIdx.x == 0 && tid == 0 && (flags & EPI_COMMIT)) epi_commit(ctl);
}

// The most blocks of epilogue_kernel the current device holds at once.
static int max_resident_blocks(int* out) {
  static int cache[MAX_DEVICES];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return (int)e;
  if (dev < MAX_DEVICES && cache[dev]) {
    *out = cache[dev];
    return 0;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epilogue_kernel, EPI_THREADS, 0);
  if (e) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e) return (int)e;
  *out = per_sm * sms;
  if (dev < MAX_DEVICES) cache[dev] = *out;
  return 0;
}

MT_ERROR_STRING_FN

// lflags: u8[L] scratch for the plan's per-lane flags. The grid is
// EPI_ROW_WARPS warps a lane, at most what the card holds at once.
MT_EXPORT int mt_round_epilogue(const Planes* P, const Planes* Sc, const uint8_t* prune_revert,
                                const uint8_t* unsat, int32_t* acc, int32_t* order, uint8_t* dying,
                                uint8_t* lflags, uint8_t* pv, int32_t* ctl, int max_rounds, int n_shards,
                                int flags, const int32_t* gate, int nfields, cudaStream_t stream) {
  if (nfields != NFIELDS) return (int)cudaErrorInvalidValue;
  if (P->L > EPI_MAX_LANES || P->L <= 0) return (int)cudaErrorInvalidConfiguration;
  if (n_shards < 1 || P->L % n_shards != 0) return (int)cudaErrorInvalidValue;
  int most;
  int err = max_resident_blocks(&most);
  if (err) return err;
  const int need = (P->L * EPI_ROW_WARPS + EPI_THREADS / 32 - 1) / (EPI_THREADS / 32);
  const int grid = need < most ? need : most;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  Planes Pv = *P, Sv = *Sc;
  void* args[] = {&Pv, &Sv, (void*)&prune_revert, (void*)&unsat, (void*)&acc, (void*)&order, (void*)&dying,
                  (void*)&lflags, (void*)&pv, (void*)&ctl, &max_rounds, &n_shards, &flags, (void*)&gate};
  err = (int)cudaLaunchCooperativeKernel((const void*)epilogue_kernel, dim3(grid), dim3(EPI_THREADS), args, 0,
                                     stream);
  if (err) {
    cudaGetLastError();  // leave no error behind for the next launch's check
    return err;
  }
  return (int)cudaGetLastError();
}

// out = [registers per thread, local bytes per thread (spills and stack),
// static shared bytes per block, threads per block, blocks resident per
// SM, SMs]: what chip_smoke.py prints beside K4's times.
MT_EXPORT int mt_round_epilogue_info(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, epilogue_kernel);
  if (e) return (int)e;
  int dev, per_sm = 0, sms = 0;
  if ((e = cudaGetDevice(&dev))) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epilogue_kernel, EPI_THREADS, 0)))
    return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = EPI_THREADS;
  out[4] = per_sm;
  out[5] = sms;
  return 0;
}
