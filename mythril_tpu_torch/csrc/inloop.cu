// K3: the in-loop UNSAT screen (replaces mythril_tpu/laser/tpu/
// inloop_solve.py:123 unsat_mask). One thread per lane.
#include "inloop.cuh"

__global__ void unsat_kernel(Planes P, Pool pool, uint8_t* out, const int32_t* ctl) {
  if (ctl && !ctl[1]) return;
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.L) return;
  out[lane] = unsat_lane(P, pool, lane) ? 1 : 0;
}

MT_ERROR_STRING_FN

MT_EXPORT int mt_unsat_mask(const Planes* P, const Pool* pool, uint8_t* out, const int32_t* ctl,
                            int nfields, cudaStream_t stream) {
  if (nfields != NFIELDS) return (int)cudaErrorInvalidValue;
  if (pool->V > POOL_MAX_VARS || pool->V <= 0) return (int)cudaErrorInvalidValue;
  int threads = 64;
  unsat_kernel<<<(P->L + threads - 1) / threads, threads, 0, stream>>>(*P, *pool, out, ctl);
  return (int)cudaGetLastError();
}
