// K3: the in-loop UNSAT screen (replaces mythril_tpu/laser/tpu/
// inloop_solve.py:123 unsat_mask). One warp per lane, four warps a block,
// so the 512 lanes of the main path are 128 blocks over the 132 SMs. The
// block first copies the pool (at most 256 var hashes and C x W
// literals, a few KB shared by every lane) into its shared memory; then
// a lane that is not alive and RUNNING leaves at once, and otherwise its
// warp
//  (1) stages the lane's Pn path entries and their tape nodes in its
//      slice of shared memory, 32 entries at a time;
//  (2) tests R1 and R3, each thread its entries against all of them
//      (Pn x Pn pairs, i == j included), verdict by __any_sync;
//  (3) seeds the pool assignment, each thread its vars against the
//      staged hashes;
//  (4, 5) runs the two propagation sweeps: each thread its clauses
//      against the sweep-start assignment, forced literals into shared
//      flags, __syncwarp(), then each var's owner applies them.
// Why the pool is staged: read through the read-only cache instead, K3
// took 0.021 ms on the 64 x 64 x 8 pool case and 0.011 ms on the same
// lanes with the empty pool (chip_smoke.py): half its time
// went to the sweeps' dependent pool loads, each SM fetching the pool
// for its one block. One copy per block costs one round trip and a
// block barrier, and every later read is a shared-memory read: staged,
// K3 took 0.019 ms (NVIDIA H100 80GB HBM3, 700 W).
//
// Bound on the H100: bytes, and below a launch's own latency at the
// main path's shapes (each eligible lane's path planes and the tape nodes
// its entries name, the pool once, the mask written). What took the time
// in the one-thread-per-lane form was each thread's ~10^4 dependent loads
// from local memory; here the warp's loads are parallel and its state
// lives in shared memory.
#include "inloop.cuh"

#define UNSAT_WARPS 4
#define FULL_MASK 0xffffffffu

__global__ void __launch_bounds__(UNSAT_WARPS * 32)
    unsat_kernel(Planes P, Pool pool, uint8_t* out, const int32_t* ctl) {
  if (ctl && !ctl[1]) return;
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const Pool sp = unsat_stage_pool(pool, smem, threadIdx.x, blockDim.x);
  __syncthreads();
  const UnsatWarp w = unsat_warp(smem + unsat_pool_bytes(pool.V, pool.C, pool.W) + wid * unsat_warp_bytes(P.P, pool.V),
                                 P.P, pool.V);
  for (int lane = blockIdx.x * UNSAT_WARPS + wid; lane < P.L; lane += gridDim.x * UNSAT_WARPS) {
    bool hit = false;
    if (unsat_eligible(P, lane)) {
      unsat_stage(P, lane, w, t);
      __syncwarp();
      hit = __any_sync(FULL_MASK, unsat_r13(P.P, w, t));
      if (!hit) {
        unsat_seed(sp, P.P, w, t);
        __syncwarp();
        bool conflict = false;
        for (int sweep = 0; sweep < PROP_SWEEPS; ++sweep) {
          conflict |= unsat_clauses(sp, w, t);
          __syncwarp();
          conflict |= unsat_apply(sp, w, t);
          __syncwarp();
        }
        hit = __any_sync(FULL_MASK, conflict);
      }
    }
    if (t == 0) out[lane] = hit ? 1 : 0;
  }
}

MT_ERROR_STRING_FN

MT_EXPORT int mt_unsat_mask(const Planes* P, const Pool* pool, uint8_t* out, const int32_t* ctl,
                            int nfields, cudaStream_t stream) {
  if (nfields != NFIELDS) return (int)cudaErrorInvalidValue;
  if (pool->V > POOL_MAX_VARS || pool->V <= 0 || pool->C <= 0 || pool->W <= 0 || P->P <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t smem =
      unsat_pool_bytes(pool->V, pool->C, pool->W) + UNSAT_WARPS * unsat_warp_bytes(P->P, pool->V);
  if (smem > 48 * 1024) {
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(unsat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e) return (int)e;
  }
  const int blocks = (P->L + UNSAT_WARPS - 1) / UNSAT_WARPS;
  unsat_kernel<<<blocks, UNSAT_WARPS * 32, smem, stream>>>(*P, *pool, out, ctl);
  return (int)cudaGetLastError();
}

// out = [registers per thread, local bytes per thread (spills and stack),
// static shared bytes per block, threads per block]: what chip_smoke.py
// prints beside K3's times.
MT_EXPORT int mt_unsat_mask_info(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, unsat_kernel);
  if (e) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = UNSAT_WARPS * 32;
  return 0;
}
