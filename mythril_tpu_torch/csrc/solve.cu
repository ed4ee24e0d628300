// K5: the batched 3-CNF decider (replaces mythril_tpu/laser/tpu/
// solver_jax.py:457 _solve_kernel, jitted at :616-622). One block per
// instance runs solve_block (solve.cuh): the clause list is copied once
// from device memory with cp.async through a two-chunk stage and packed
// into int16 lists in dynamic shared memory (6 bytes a clause), beside
// the per-variable arrays (8 bytes a var); after that load no sweep
// touches device memory until the outputs are written. A sweep is the
// clause pass and the variable pass, each ending in one
// __syncthreads_or (dead, changed); notsat is a stamp and the decision's
// minima are warp reductions (__reduce_min_sync), so no thread resets a
// flag and phase 1 and phase 2 both take two block barriers a sweep.
//
// Block size by bucket (solve_threads): the clause pass gives each thread
// SOLVE_CLAUSES_PER_THREAD clauses or, past 1024 threads, more (on the
// H100, 512 threads took a sweep at (256, 1024) in 0.95 us against 1.23
// at 256 and 1.00 at 1024; 1024 threads were fastest at the two larger
// buckets: chip_smoke.time_solve_per_sweep); the launch's threads are
// reported by mt_solve_info beside the compiled resources.
//
// Bound on the H100: bytes, the operands read once (12 bytes a clause,
// 6 a var, 4 an instance) and the outputs written once; at the main
// path's shape that is a few tens of KB, so the launch is latency-bound:
// its time is the chain of sweeps, each two barriers and two passes over
// shared memory. Left out: spreading one instance over a cluster of
// blocks (at 8 instances, 124 of the 132 SMs idle).
#include "solve.cuh"

#define SOLVE_CLAUSES_PER_THREAD 2

// the block a launch gives an instance, as solve_block sees it
struct SolveBlock {
  int t, n;
  template <class F>
  __device__ __forceinline__ void each(F f) {
    f(t);
  }
  __device__ __forceinline__ void sync() { __syncthreads(); }
  template <class F>
  __device__ __forceinline__ bool sync_or(F f) {
    return __syncthreads_or(f(t) ? 1 : 0) != 0;
  }
  // lane 0 of each warp stores the warp's least v into w[warp]
  __device__ __forceinline__ void warp_min(int32_t* w, int v, int tid) {
    const int m = __reduce_min_sync(0xffffffffu, v);
    if ((tid & 31) == 0) w[tid >> 5] = m;
  }
  // the least of the warps' words, in every thread
  __device__ __forceinline__ int block_min(const int32_t* w) {
    const int lane = t & 31;
    return __reduce_min_sync(0xffffffffu, lane < (n >> 5) ? w[lane] : 0x7fffffff);
  }
};

__global__ void __launch_bounds__(SOLVE_MAX_THREADS) solve_kernel(SolveArgs a) {
  extern __shared__ __align__(16) uint8_t solve_smem[];
  __shared__ SolveShared sh;
  SolveBlock blk{(int)threadIdx.x, (int)blockDim.x};
  const SolveSmem s = solve_carve(solve_smem, a.C, a.V, solve_chunk(a.C, a.V, blockDim.x));
  solve_block(blk, a, s, sh, blockIdx.x);
}

// threads a block for C clauses: SOLVE_CLAUSES_PER_THREAD clauses each,
// a whole number of warps, 64 to 1024
static int solve_threads(int C) {
  int t = (C + SOLVE_CLAUSES_PER_THREAD - 1) / SOLVE_CLAUSES_PER_THREAD;
  t = (t + 31) / 32 * 32;
  return t < 64 ? 64 : (t > SOLVE_MAX_THREADS ? SOLVE_MAX_THREADS : t);
}

MT_ERROR_STRING_FN

// threads 0: solve_threads(C); else that many (a multiple of 32, <= 1024)
MT_EXPORT int mt_solve(const int32_t* lits, const int32_t* nvars, const uint8_t* is_input,
                       const int8_t* warm, int32_t* status, uint8_t* assign, int32_t* sweeps,
                       int I, int C, int V, int flips, int threads, uint32_t seed, cudaStream_t stream) {
  if (I <= 0 || C < 0 || V <= 0 || V > SOLVE_MAX_VARS || flips < 0) return (int)cudaErrorInvalidValue;
  if (threads == 0) threads = solve_threads(C);
  if (threads < 32 || threads % 32 || threads > SOLVE_MAX_THREADS) return (int)cudaErrorInvalidValue;
  const int64_t smem = solve_smem_bytes(C, V, threads);
  if (smem + (int64_t)sizeof(SolveShared) > 232448) return (int)cudaErrorInvalidValue;  // 227 KB a block
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  SolveArgs a{lits, nvars, is_input, warm, status, assign, sweeps, C, V, flips, seed,
              ((uintptr_t)lits & 15) == 0 && C % 4 == 0};
  solve_kernel<<<I, threads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// out = [registers per thread, local bytes per thread, static shared
// bytes, threads per block, dynamic shared bytes, blocks resident per SM]
// of a launch for C clauses over V vars (threads 0: the bucket's choice)
MT_EXPORT int mt_solve_info(int* out, int C, int V, int threads) {
  if (threads == 0) threads = solve_threads(C);
  const int64_t smem = solve_smem_bytes(C, V, threads);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, solve_kernel);
  if (e) return (int)e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return (int)e;
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solve_kernel, threads, (size_t)smem))) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = threads;
  out[4] = (int)smem;
  out[5] = per_sm;
  return 0;
}
