// K1: the step kernel group (replaces mythril_tpu/laser/tpu/engine.py:118
// step_impl). Per step: plan (one block ranks the fork requests and
// writes each lane's concrete-SHA3 window), then K2 hashes those windows
// (launched by the Python wrapper from the keccak library), then lane
// (one thread per lane, in place) and fork (one block per forking parent
// copies its lane into the child). Each kernel reads the fused loop's
// control word first (ctl may be null outside the loop). With n_shards
// > 1 (the fused mesh tier) the plan ranks forks inside each of the
// n_shards contiguous lane blocks, one thread per block; with n_shards = 1
// the one block is every lane (the single-device plan, thread 0).
#include "step.cuh"

#define PLAN_MAX_LANES 1024

__global__ void step_plan_kernel(Planes P, Bank B, const int32_t* tab, int32_t* slot,
                                 uint8_t* sha_active, int32_t* sha_off, int32_t* sha_avail,
                                 int32_t* sha_len, const int32_t* ctl, int n_shards) {
  if (ctl && !ctl[1]) return;
  __shared__ uint8_t free_s[PLAN_MAX_LANES];
  __shared__ uint8_t req_s[PLAN_MAX_LANES];
  __shared__ int32_t rank_s[PLAN_MAX_LANES];
  for (int l = threadIdx.x; l < P.L; l += blockDim.x) {
    int dest;
    free_s[l] = PL(uint8_t, F_ALIVE)[l] ? 0 : 1;
    req_s[l] = fork_base_of(P, B, tab, l, &dest) ? 1 : 0;
    sha_request(P, B, l, sha_active, sha_off, sha_avail, sha_len);
  }
  __syncthreads();
  int per = P.L / n_shards;
  for (int s = threadIdx.x; s < n_shards; s += blockDim.x)
    plan_assign_block(per, s * per, free_s, req_s, slot, rank_s);
}

__global__ void step_lane_kernel(Planes P, Bank B, const int32_t* tab, const int32_t* slot,
                                 const uint8_t* sha_digest, uint8_t* fork_do, int32_t* fork_dest,
                                 const int32_t* ctl) {
  if (ctl && !ctl[1]) return;
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.L) return;
  step_lane(P, B, tab, slot, sha_digest, fork_do, fork_dest, lane);
}

__global__ void step_fork_kernel(Planes P, const uint8_t* fork_do, const int32_t* slot,
                                 const int32_t* fork_dest, const int32_t* ctl) {
  if (ctl && !ctl[1]) return;
  int parent = blockIdx.x;
  if (!fork_do[parent]) return;
  int child = slot[parent];
  copy_row_part(P, P, parent, child, threadIdx.x, blockDim.x);
  __syncthreads();
  if (threadIdx.x == 0) fork_child_edits(P, child, fork_dest[parent]);
}

MT_ERROR_STRING_FN

MT_EXPORT int mt_step_plan(const Planes* P, const Bank* B, const int32_t* tab, int32_t* slot,
                           uint8_t* sha_active, int32_t* sha_off, int32_t* sha_avail,
                           int32_t* sha_len, const int32_t* ctl, int n_shards, int nfields,
                           cudaStream_t stream) {
  if (nfields != NFIELDS) return (int)cudaErrorInvalidValue;
  if (P->L > PLAN_MAX_LANES || P->L <= 0) return (int)cudaErrorInvalidConfiguration;
  if (n_shards < 1 || P->L % n_shards != 0) return (int)cudaErrorInvalidValue;
  step_plan_kernel<<<1, P->L < 256 ? P->L : 256, 0, stream>>>(*P, *B, tab, slot, sha_active,
                                                                sha_off, sha_avail, sha_len, ctl,
                                                                n_shards);
  return (int)cudaGetLastError();
}

MT_EXPORT int mt_step_lanes(const Planes* P, const Bank* B, const int32_t* tab, const int32_t* slot,
                            const uint8_t* sha_digest, uint8_t* fork_do, int32_t* fork_dest,
                            const int32_t* ctl, int nfields, int lane_threads,
                            cudaStream_t stream) {
  if (nfields != NFIELDS) return (int)cudaErrorInvalidValue;
  step_lane_kernel<<<(P->L + lane_threads - 1) / lane_threads, lane_threads, 0, stream>>>(
      *P, *B, tab, slot, sha_digest, fork_do, fork_dest, ctl);
  int err = (int)cudaGetLastError();
  if (err) return err;
  step_fork_kernel<<<P->L, 256, 0, stream>>>(*P, fork_do, slot, fork_dest, ctl);
  return (int)cudaGetLastError();
}
