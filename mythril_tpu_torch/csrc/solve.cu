// K5: the batched 3-CNF decider (replaces mythril_tpu/laser/tpu/
// solver_jax.py:457 _solve_kernel, jitted at :616-622). One block per
// instance: the assignment, the phase-1 fixpoint and the per-sweep force
// buffer live in shared memory (V * 6 bytes), the threads stride over the
// C clauses in device memory, and phase 1 and phase 2 loop inside the
// block with block-wide flags. See solve.cuh for the semantics.
#include "solve.cuh"

#define SOLVE_THREADS 256

__global__ void solve_kernel(const int32_t* lits, const int32_t* nvars, const uint8_t* is_input,
                             const int8_t* warm, int32_t* status, uint8_t* assign,
                             int32_t* sweeps, int C, int V, int flips, uint32_t seed) {
  extern __shared__ int32_t solve_smem[];
  __shared__ SolveFlags flags;
  int32_t* upd = solve_smem;
  int8_t* val = (int8_t*)(upd + V);
  int8_t* fixed = val + V;
  solve_instance(lits, nvars, is_input, warm, status, assign, sweeps, C, V, flips, seed,
                 blockIdx.x, val, fixed, upd, &flags, threadIdx.x, blockDim.x);
}

MT_ERROR_STRING_FN

MT_EXPORT int mt_solve(const int32_t* lits, const int32_t* nvars, const uint8_t* is_input,
                       const int8_t* warm, int32_t* status, uint8_t* assign, int32_t* sweeps,
                       int I, int C, int V, int flips, uint32_t seed, cudaStream_t stream) {
  if (I <= 0 || C < 0 || V <= 0) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)V * (sizeof(int32_t) + 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  solve_kernel<<<I, SOLVE_THREADS, smem, stream>>>(lits, nvars, is_input, warm, status, assign,
                                                   sweeps, C, V, flips, seed);
  return (int)cudaGetLastError();
}
