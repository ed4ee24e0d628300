// K4: the fused round's epilogue (replaces the tail of
// mythril_tpu/laser/tpu/megakernel.py:134 _one_round: prune_mask :113,
// the in-loop kill, the counter folds, pruned_visited, compact_impl :121).
// Four launches: plan (one block), gather into scratch (one block per
// destination lane), copy-back (one block per lane), control commit.
#include "megakernel.cuh"

#define EPI_MAX_LANES 1024

__global__ void epi_plan_kernel(Planes P, const uint8_t* prune_revert, const uint8_t* unsat,
                                int32_t* acc, int32_t* order, uint8_t* dying, int32_t* ctl,
                                int max_rounds) {
  if (!ctl[1]) return;
  __shared__ uint8_t dead_s[EPI_MAX_LANES];
  __shared__ uint8_t dying_s[EPI_MAX_LANES];
  for (int l = threadIdx.x; l < P.L; l += blockDim.x) {
    bool dead;
    dying_s[l] = dying_of(P, prune_revert, unsat, l, &dead) ? 1 : 0;
    dead_s[l] = dead ? 1 : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) epi_plan_serial(P, dead_s, dying_s, acc, order, dying, ctl, max_rounds);
}

__global__ void epi_gather_kernel(Planes P, Planes Sc, const int32_t* order, const uint8_t* dying,
                                  uint8_t* pv, const int32_t* ctl) {
  if (!ctl[1]) return;
  int d = blockIdx.x;
  copy_row_part(P, Sc, order[d], d, threadIdx.x, blockDim.x);
  __syncthreads();
  epi_fold_lane(P, Sc, order, dying, pv, d, threadIdx.x, blockDim.x);
}

__global__ void epi_copyback_kernel(Planes Sc, Planes P, const int32_t* ctl) {
  if (!ctl[1]) return;
  copy_row_part(Sc, P, blockIdx.x, blockIdx.x, threadIdx.x, blockDim.x);
}

__global__ void epi_ctl_kernel(int32_t* ctl) {
  if (!ctl[1]) return;
  ctl[0] = ctl[2];
  ctl[1] = ctl[3];
}

MT_ERROR_STRING_FN

MT_EXPORT int mt_round_epilogue(const Planes* P, const Planes* Sc, const uint8_t* prune_revert,
                                const uint8_t* unsat, int32_t* acc, int32_t* order,
                                uint8_t* dying, uint8_t* pv, int32_t* ctl, int max_rounds,
                                int nfields, cudaStream_t stream) {
  if (nfields != NFIELDS) return (int)cudaErrorInvalidValue;
  if (P->L > EPI_MAX_LANES || P->L <= 0) return (int)cudaErrorInvalidConfiguration;
  epi_plan_kernel<<<1, P->L < 256 ? P->L : 256, 0, stream>>>(*P, prune_revert, unsat, acc, order,
                                                               dying, ctl, max_rounds);
  int err = (int)cudaGetLastError();
  if (err) return err;
  epi_gather_kernel<<<P->L, 256, 0, stream>>>(*P, *Sc, order, dying, pv, ctl);
  err = (int)cudaGetLastError();
  if (err) return err;
  epi_copyback_kernel<<<P->L, 256, 0, stream>>>(*Sc, *P, ctl);
  err = (int)cudaGetLastError();
  if (err) return err;
  epi_ctl_kernel<<<1, 1, 0, stream>>>(ctl);
  return (int)cudaGetLastError();
}
