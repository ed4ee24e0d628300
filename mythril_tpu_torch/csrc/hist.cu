// K8: the retired-opcode histogram of one step (replaces
// mythril_tpu/laser/tpu/engine.py:1398 op_hist_update), from the pre-step
// code_id, pc and steps and the post-step steps: the standalone
// counterpart of the reference's function (engine.op_hist_update). No
// loop of the port launches it: the fused rounds and the sync slice fold
// their steps' opcodes inside K1's launch (step.cu, its stats instance,
// with the same lane logic from hist.cuh). One thread per lane computes
// its bin; each block keeps a 256-bin histogram in shared memory and adds
// it into the u32[256] output with one atomicAdd per nonzero bin.
// Bound: bytes (3 x 4 B before + 4 B steps + 1 code byte per lane read,
// 1 KB of histogram); at L = 512 it is launch-bound.
#include "hist.cuh"

__global__ void op_hist_kernel(const uint8_t* code, int n_codes, int CL, const int32_t* b_cid,
                               const int32_t* b_pc, const int32_t* b_steps, const int32_t* a_steps, int L,
                               uint32_t* hist) {
  __shared__ uint32_t local[HIST_BINS];
  for (int i = threadIdx.x; i < HIST_BINS; i += blockDim.x) local[i] = 0;
  __syncthreads();
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l < L) {
    int b = hist_bin(code, n_codes, CL, b_cid[l], b_pc[l], b_steps[l], a_steps[l]);
    if (b < HIST_BINS) atomicAdd(&local[b], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HIST_BINS; i += blockDim.x)
    if (local[i]) atomicAdd(&hist[i], local[i]);
}

MT_ERROR_STRING_FN

MT_EXPORT int mt_op_hist(const uint8_t* code, int n_codes, int CL, const int32_t* b_cid, const int32_t* b_pc,
                         const int32_t* b_steps, const int32_t* a_steps, int L, uint32_t* hist,
                         cudaStream_t stream) {
  if (L <= 0) return 0;
  if (n_codes <= 0 || CL <= 0) return (int)cudaErrorInvalidValue;
  int threads = 256;
  op_hist_kernel<<<(L + threads - 1) / threads, threads, 0, stream>>>(code, n_codes, CL, b_cid, b_pc, b_steps,
                                                                      a_steps, L, hist);
  return (int)cudaGetLastError();
}
