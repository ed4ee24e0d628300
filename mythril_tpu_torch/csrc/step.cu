// K1: the step kernel (replaces mythril_tpu/laser/tpu/engine.py:118
// step_impl, and the reference round's lax.fori_loop over it,
// megakernel.py:165). One cooperative launch runs n_steps steps of every
// lane. Per step:
//  (a) every lane's flags (free, fork request, running; lane_flags) from
//      the pre-step state into scratch, one thread per lane; grid.sync();
//  (b) the fork rank (step.cuh): every block scans all the flags in its
//      own shared memory, so no third barrier hands slots around. When
//      no lane runs, every block leaves: they read the same flags, and a
//      step without a running lane changes nothing;
//  (c) the lane pass: each warp owns one lane in a grid-stride loop over
//      the grid's warps, so no warp pays for another lane's opcode
//      branches. Its thread 0 steps the lane (step_lane, SHA3 hashed
//      there from the lane's own pre-step memory); if the lane forks,
//      the whole warp copies its post-step row into the child and thread
//      0 applies the child's edits; grid.sync().
// A child is a lane that was free when the step began, given to exactly
// one parent, so nothing else touches it in the step and no barrier has
// to separate the copies from the lane pass: its owner skips it by the
// step's flags (lane_pass), never by the live planes the copy rewrites.
//
// With stats (hist not null; the kernel's STATS instance) the launch also
// folds every step's retired opcodes into hist, u32[256], as the
// reference's op_hist_update after each step (hist.cuh). In part (a) the
// thread that computes a lane's flags first compares the lane's steps
// with what it recorded before the previous step, adding the recorded
// opcode into the block's shared bins if they advanced, then records the
// lane's pre-step opcode and steps into rec. Every lane is recorded before
// any parent's warp copies into a child, so a child is binned from its
// lane's own stale row, as in the reference. The last step's fold runs
// after the loop; every exit path flushes the block's bins into hist with
// one atomic per nonzero bin, after a block barrier. No grid barrier is
// added. The stats-off instance compiles to the kernel without any of
// this.
//
// ctl (the fused loop's control word, null outside it) is read once:
// nothing inside a launch writes it, so every block takes the same
// branch and reaches the same grid.sync()s. The grid is as many blocks
// as the lanes need, at most what fits on the card at once (occupancy x
// SMs), since a cooperative launch must be resident as a whole; a
// refused launch returns its CUDA error, and the wrapper raises.
//
// Bound on the H100: bytes (each running lane's fetch, operands and the
// planes its opcode touches; each child's whole row; with stats, each
// lane's code_id, pc and steps and its code byte, and 1 KB of hist).
// At the main path's shapes the step is latency-bound: the slowest lane's
// serial step and two grid barriers per step.
#include <cooperative_groups.h>

#include "step.cuh"

namespace cg = cooperative_groups;

#define RUN_THREADS 128
#define MAX_DEVICES 64

// the block's shared state: the rank's, and with stats the bins
template <bool STATS>
struct RunShared {
  typedef StepShared type;
};
template <>
struct RunShared<true> {
  typedef StepSharedHist type;
};

// with stats, on every exit: the block's bins into hist
__device__ __forceinline__ void flush_bins(const StepSharedHist& ss, uint32_t* hist, int tid, int nt) {
  __syncthreads();
  for (int i = tid; i < HIST_BINS; i += nt)
    if (ss.bins[i]) atomicAdd(&hist[i], ss.bins[i]);
}

template <bool STATS>
__global__ void __launch_bounds__(RUN_THREADS)
    step_run_kernel(Planes P, Bank B, const int32_t* tab, uint8_t* flags, const int32_t* ctl,
                    uint32_t* hist, int32_t* rec, int n_shards, int n_steps) {
  if (ctl && !ctl[1]) return;
  cg::grid_group grid = cg::this_grid();
  __shared__ typename RunShared<STATS>::type ss;
  const int tid = threadIdx.x, nt = blockDim.x, wl = tid & 31;
  const int L = P.L, per = L / n_shards;
  const int gtid = blockIdx.x * nt + tid, gthreads = gridDim.x * nt;
  const int gwarp = blockIdx.x * (nt / 32) + (tid >> 5), nwarps = gridDim.x * (nt / 32);
  if constexpr (STATS)
    for (int i = tid; i < HIST_BINS; i += nt) ss.bins[i] = 0;
  for (int step = 0; step < n_steps; ++step) {
    // (a)
    for (int l = gtid; l < L; l += gthreads) {
      if constexpr (STATS) {
        if (step) hist_fold(P, rec, ss.bins, l);
        hist_record(P, B.code, rec, l);
      }
      flags[l] = lane_flags(P, B, tab, l);
    }
    grid.sync();
    // (b)
    rank_sum_chunk(L, flags, ss.rs, tid, nt);
    __syncthreads();
    rank_scan_warp(ss.rs, tid);
    __syncthreads();
    rank_prefix(L, flags, ss.rs, tid, nt);
    __syncthreads();
    rank_scatter(L, flags, ss, tid, nt);
    __syncthreads();
    if (!rank_any_running(ss.rs, L)) {
      if constexpr (STATS) flush_bins(ss, hist, tid, nt);
      return;
    }
    // (c)
    for (int lane = gwarp; lane < L; lane += nwarps) {
      int child = SLOT_NONE, dest = 0, fork = 0;
      if (wl == 0) {
        child = fork_slot(L, per, flags, ss, lane);
        fork = lane_pass(P, B, tab, flags, child, lane, &dest);
      }
      if (__shfl_sync(0xffffffffu, fork, 0)) {
        child = __shfl_sync(0xffffffffu, child, 0);
        copy_row_part(P, P, lane, child, wl, 32);
        __syncwarp();
        if (wl == 0) fork_child_edits(P, child, dest);
      }
      __syncwarp();
    }
    grid.sync();
  }
  if constexpr (STATS) {
    for (int l = gtid; l < L; l += gthreads) hist_fold(P, rec, ss.bins, l);
    flush_bins(ss, hist, tid, nt);
  }
}

static const void* const RUN_KERNELS[2] = {(const void*)step_run_kernel<false>,
                                           (const void*)step_run_kernel<true>};

// The most blocks of one instance of step_run_kernel the current device
// holds at once.
static int max_resident_blocks(int stats, int* out) {
  static int cache[2][MAX_DEVICES];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return (int)e;
  if (dev < MAX_DEVICES && cache[stats][dev]) {
    *out = cache[stats][dev];
    return 0;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, RUN_KERNELS[stats], RUN_THREADS, 0);
  if (e) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e) return (int)e;
  *out = per_sm * sms;
  if (dev < MAX_DEVICES) cache[stats][dev] = *out;
  return 0;
}

MT_ERROR_STRING_FN

// blocks: 0 sizes the grid from the lanes and what the card holds at
// once; a positive count launches exactly that many blocks (more than
// fit is refused by the card: chip_smoke.py checks that it raises).
// hist: null, or u32[256] that the launch adds its retired opcodes into,
// with rec int32[2L] of scratch.
MT_EXPORT int mt_step_run(const Planes* P, const Bank* B, const int32_t* tab, uint8_t* flags,
                          const int32_t* ctl, uint32_t* hist, int32_t* rec, int n_shards, int n_steps,
                          int blocks, int nfields, cudaStream_t stream) {
  if (nfields != NFIELDS) return (int)cudaErrorInvalidValue;
  if (P->L > RANK_MAX_LANES || P->L <= 0) return (int)cudaErrorInvalidConfiguration;
  if (n_shards < 1 || P->L % n_shards != 0) return (int)cudaErrorInvalidValue;
  if (n_steps < 0 || blocks < 0 || (hist && !rec)) return (int)cudaErrorInvalidValue;
  if (n_steps == 0) return 0;
  const int stats = hist != nullptr;
  int grid = blocks;
  if (!grid) {
    int most;
    int err = max_resident_blocks(stats, &most);
    if (err) return err;
    const int need = (P->L + RUN_THREADS / 32 - 1) / (RUN_THREADS / 32);
    grid = need < most ? need : most;
    if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  Planes Pv = *P;
  Bank Bv = *B;
  void* args[] = {&Pv, &Bv, (void*)&tab, (void*)&flags, (void*)&ctl, (void*)&hist, (void*)&rec,
                  &n_shards, &n_steps};
  int err = (int)cudaLaunchCooperativeKernel(RUN_KERNELS[stats], dim3(grid), dim3(RUN_THREADS), args, 0,
                                             stream);
  if (err) {
    cudaGetLastError();  // leave no error behind for the next launch's check
    return err;
  }
  return (int)cudaGetLastError();
}

// out = [registers per thread, local bytes per thread (spills and stack),
// static shared bytes per block, threads per block, blocks resident per
// SM, SMs] of the stats-off (stats 0) or stats (1) instance: what
// chip_smoke.py prints beside K1's times.
MT_EXPORT int mt_step_run_info(int* out, int stats) {
  if (stats != 0 && stats != 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, RUN_KERNELS[stats]);
  if (e) return (int)e;
  int dev, per_sm = 0, sms = 0;
  if ((e = cudaGetDevice(&dev))) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, RUN_KERNELS[stats], RUN_THREADS, 0)))
    return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = RUN_THREADS;
  out[4] = per_sm;
  out[5] = sms;
  return 0;
}
