// K9: the sync slice loop's condition (replaces the cond of
// mythril_tpu/laser/tpu/engine.py:1415 _run_impl's while_loop): one block
// reduces alive & RUNNING over the L lanes and commits the control word.
// The slice itself is one K1 launch of max_steps steps, which stops on
// the same condition by itself (step.cu), so no loop launches K9 per
// step; the backend's quiescence read between slices
// (engine.any_running) is one K9 into a fresh word and one fetch of it.
// Bound: bytes (5 B per lane read); launch-bound at L = 512.
#include "slice.cuh"

__global__ void slice_ctl_kernel(const uint8_t* alive, const int32_t* status, int L, int32_t* ctl,
                                 int max_steps) {
  int mine = 0;
  for (int l = threadIdx.x; l < L; l += blockDim.x) mine |= lane_running(alive, status, l);
  int any_running = __syncthreads_or(mine);
  if (threadIdx.x == 0) slice_ctl_commit(ctl, any_running ? 1 : 0, max_steps);
}

MT_ERROR_STRING_FN

MT_EXPORT int mt_slice_ctl(const uint8_t* alive, const int32_t* status, int L, int32_t* ctl,
                           int max_steps, cudaStream_t stream) {
  if (L < 0) return (int)cudaErrorInvalidValue;
  slice_ctl_kernel<<<1, 256, 0, stream>>>(alive, status, L, ctl, max_steps);
  return (int)cudaGetLastError();
}
