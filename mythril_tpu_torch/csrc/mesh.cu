// K10 mesh_plan, K11 mesh_steal, K12 mesh_deal: the mesh tiers on one
// card (replace mythril_tpu/laser/tpu/mesh.py:127 steal_plan with :237
// occupancy_impl, :178 steal_apply, and :83 rebalance). The mesh is n
// contiguous lane blocks of one batch (mesh.cuh).
//
// K10: one block. One thread per shard counts its block, thread 0 plans
// the shard-level scalars, one thread per shard ranks its lanes; the
// steal decision goes into mctl, which K11 and the compaction after it
// read, so the fused mesh loop never asks the host whether to steal.
// K11: one block per lane; the blocks of exported lanes copy their row
// into the receiver's slot (copy_row_part, as a fork child is written)
// and kill the exporter. K12: one block orders the deal, one block per
// lane gathers every plane's row into scratch, one per lane copies back.
// Bound on the H100: bytes (the lanes' rows moved; K10 reads 5 bytes a
// lane); at L = 512 all three are launch- and latency-bound.
#include "mesh.cuh"

#define MESH_MAX_LANES 1024

__global__ void mesh_plan_kernel(Planes P, int n, int flags, uint8_t* export_, int32_t* buf_pos,
                                 int32_t* sh, int32_t* mctl, const int32_t* ctl) {
  if (ctl && !ctl[1]) return;
  __shared__ int32_t sur[MESH_MAX_SHARDS], dbase[MESH_MAX_SHARDS], rbase[MESH_MAX_SHARDS],
      rend[MESH_MAX_SHARDS];
  __shared__ int moved_s;
  const int per = P.L / n;
  for (int s = threadIdx.x; s < n; s += blockDim.x) mesh_count_shard(P, per, s, n, sh);
  if (!(flags & MESH_PLAN)) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    moved_s = mesh_plan_scalars(per, n, sh, sur, dbase, rbase, rend);
    mesh_commit(sh, n, moved_s, flags, mctl);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n; s += blockDim.x)
    mesh_plan_shard(P, per, n, s, sh, sur, dbase, rbase, rend, moved_s, export_, buf_pos);
}

__global__ void mesh_steal_kernel(Planes P, int n, const uint8_t* export_, const int32_t* buf_pos,
                                  const int32_t* sh, const int32_t* ctl, const int32_t* gate) {
  if ((ctl && !ctl[1]) || (gate && !gate[0])) return;
  int lane = blockIdx.x;
  if (!export_[lane]) return;
  int per = P.L / n;
  copy_row_part(P, P, lane, mesh_target(sh, per, n, buf_pos[lane]), threadIdx.x, blockDim.x);
  __syncthreads();
  mesh_kill_part(P, lane, threadIdx.x, blockDim.x);
}

__global__ void mesh_order_kernel(Planes P, int n, int32_t* order) {
  __shared__ int32_t packed[MESH_MAX_LANES];
  if (threadIdx.x == 0) mesh_deal_order(P, n, packed, order);
}

__global__ void mesh_gather_kernel(Planes P, Planes Sc, const int32_t* order) {
  copy_row_part(P, Sc, order[blockIdx.x], blockIdx.x, threadIdx.x, blockDim.x);
}

__global__ void mesh_copyback_kernel(Planes Sc, Planes P) {
  copy_row_part(Sc, P, blockIdx.x, blockIdx.x, threadIdx.x, blockDim.x);
}

static int mesh_args_ok(const Planes* P, int n, int nfields) {
  if (nfields != NFIELDS) return 0;
  if (P->L <= 0 || P->L > MESH_MAX_LANES) return 0;
  return n >= 1 && n <= MESH_MAX_SHARDS && P->L % n == 0;
}

MT_ERROR_STRING_FN

MT_EXPORT int mt_mesh_plan(const Planes* P, int n, int flags, uint8_t* export_, int32_t* buf_pos,
                           int32_t* sh, int32_t* mctl, const int32_t* ctl, int nfields,
                           cudaStream_t stream) {
  if (!mesh_args_ok(P, n, nfields)) return (int)cudaErrorInvalidValue;
  mesh_plan_kernel<<<1, 64, 0, stream>>>(*P, n, flags, export_, buf_pos, sh, mctl, ctl);
  return (int)cudaGetLastError();
}

MT_EXPORT int mt_mesh_steal(const Planes* P, int n, const uint8_t* export_, const int32_t* buf_pos,
                            const int32_t* sh, const int32_t* ctl, const int32_t* gate,
                            int nfields, cudaStream_t stream) {
  if (!mesh_args_ok(P, n, nfields)) return (int)cudaErrorInvalidValue;
  mesh_steal_kernel<<<P->L, 256, 0, stream>>>(*P, n, export_, buf_pos, sh, ctl, gate);
  return (int)cudaGetLastError();
}

MT_EXPORT int mt_mesh_deal(const Planes* P, const Planes* Sc, int n, int32_t* order, int nfields,
                           cudaStream_t stream) {
  if (!mesh_args_ok(P, n, nfields)) return (int)cudaErrorInvalidValue;
  mesh_order_kernel<<<1, 32, 0, stream>>>(*P, n, order);
  int err = (int)cudaGetLastError();
  if (err) return err;
  mesh_gather_kernel<<<P->L, 256, 0, stream>>>(*P, *Sc, order);
  err = (int)cudaGetLastError();
  if (err) return err;
  mesh_copyback_kernel<<<P->L, 256, 0, stream>>>(*Sc, *P);
  return (int)cudaGetLastError();
}
