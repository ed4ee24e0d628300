// K10-K12 logic: the mesh tiers on one card (replaces
// mythril_tpu/laser/tpu/mesh.py). A mesh of n shards is n contiguous
// blocks of per = L / n lanes of one batch, as shard_map sees the
// lane-sharded planes. What crossed devices there (the all_gather of the
// counts, the all_to_all of the exported rows, the global deal) is a
// plan in one block and row copies here.
//
//   sh   = int32[3n]: occ (running lanes), alive_c (alive lanes), filled
//          (lanes each shard imports), per shard
//   mctl = int32[4]: [do_steal, moved, steal_events, steal_lanes]
#pragma once
#include "common.cuh"

#define MESH_MAX_SHARDS 64

// K10 flags: plan the steal (else count only); gate the steal on the
// spread (the fused loop, megakernel.py:401-410: moved > 0 and
// max(occ) - min(occ) > 1; else moved > 0); add the event to mctl[2..3]
#define MESH_PLAN 1
#define MESH_GATE_SPREAD 2
#define MESH_ACCUM 4

MT_DEV bool mesh_running(const Planes& P, int l) {
  return PL(uint8_t, F_ALIVE)[l] && PL(int32_t, F_STATUS)[l] == RUNNING;
}

// Per-shard [running, alive] counts (mesh.py:150-153, occupancy_impl :237).
MT_DEV void mesh_count_shard(const Planes& P, int per, int s, int n, int32_t* sh) {
  int run = 0, alv = 0;
  for (int l = s * per; l < (s + 1) * per; ++l) {
    run += mesh_running(P, l);
    alv += PL(uint8_t, F_ALIVE)[l] ? 1 : 0;
  }
  sh[s] = run;
  sh[n + s] = alv;
}

// The plan's shard-level scalars (mesh.py:154-168), serial over n shards:
// fair-share target, surplus, deficit capped by free lanes, exclusive
// cumsums, filled. Writes surplus/donor_base/recv_base/recv_end (each
// int32[n]) and sh's filled column; returns moved.
MT_DEV int mesh_plan_scalars(int per, int n, int32_t* sh, int32_t* surplus, int32_t* donor_base,
                             int32_t* recv_base, int32_t* recv_end) {
  const int32_t* occ = sh;
  const int32_t* alive_c = sh + n;
  int total = 0;
  for (int s = 0; s < n; ++s) total += occ[s];
  int base = total / n, rem = total - base * n;
  int32_t deficit[MESH_MAX_SHARDS];
  int sum_sur = 0, sum_def = 0;
  for (int s = 0; s < n; ++s) {
    int target = base + (s < rem ? 1 : 0);
    int free_ = per - alive_c[s];
    int sur = occ[s] - target;
    surplus[s] = sur > 0 ? sur : 0;
    int def = target - occ[s];
    def = def > 0 ? def : 0;
    deficit[s] = def < free_ ? def : free_;
    donor_base[s] = sum_sur;
    recv_base[s] = sum_def;
    sum_sur += surplus[s];
    sum_def += deficit[s];
    recv_end[s] = sum_def;
  }
  int moved = sum_sur < sum_def ? sum_sur : sum_def;
  for (int s = 0; s < n; ++s) {
    int f = moved - recv_base[s];
    sh[2 * n + s] = f < 0 ? 0 : (f > deficit[s] ? deficit[s] : f);
  }
  return moved;
}

// The lanes of shard s (mesh.py:170-180): running lanes ranked at or past
// keep export, to global donor index gidx; dest is the shard whose
// [recv_base, recv_end) holds gidx (searchsorted, side right), slot the
// offset in it. buf_pos = dest * per + slot, or n * per when not exported.
MT_DEV void mesh_plan_shard(const Planes& P, int per, int n, int s, const int32_t* sh,
                            const int32_t* surplus, const int32_t* donor_base,
                            const int32_t* recv_base, const int32_t* recv_end, int moved,
                            uint8_t* export_, int32_t* buf_pos) {
  int keep = sh[s] - surplus[s];
  int rank = -1;
  for (int l = s * per; l < (s + 1) * per; ++l) {
    bool run = mesh_running(P, l);
    rank += run ? 1 : 0;
    int gidx = donor_base[s] + rank - keep;
    bool ex = run && rank >= keep && gidx < moved;
    int pos = n * per;
    if (ex) {
      int dest = 0;
      while (dest < n && recv_end[dest] <= gidx) ++dest;
      if (dest > n - 1) dest = n - 1;
      pos = dest * per + (gidx - recv_base[dest]);
    }
    export_[l] = ex ? 1 : 0;
    buf_pos[l] = pos;
  }
}

// The steal decision and its counters (megakernel.py:401-410).
MT_DEV void mesh_commit(const int32_t* sh, int n, int moved, int flags, int32_t* mctl) {
  int lo = sh[0], hi = sh[0];
  for (int s = 1; s < n; ++s) {
    lo = sh[s] < lo ? sh[s] : lo;
    hi = sh[s] > hi ? sh[s] : hi;
  }
  bool go = moved > 0 && (!(flags & MESH_GATE_SPREAD) || hi - lo > 1);
  mctl[0] = go ? 1 : 0;
  mctl[1] = moved;
  if (flags & MESH_ACCUM) {
    mctl[2] += go ? 1 : 0;
    mctl[3] += go ? moved : 0;
  }
}

// One exported lane's move (mesh.py:178-224): its row lands at lane
// alive_c[dest] + slot of block dest, then the exporter dies with its
// counters zeroed. Donors are alive and targets free, so no two moves
// touch one lane.
MT_DEV int mesh_target(const int32_t* sh, int per, int n, int pos) {
  int dest = pos / per;
  return dest * per + sh[n + dest] + (pos - dest * per);
}

MT_DEV void mesh_kill_part(const Planes& P, int lane, int tid, int nthreads) {
  uint8_t* vis = PL(uint8_t, F_VISITED) + (int64_t)lane * P.CL;
  for (int j = tid; j < P.CL; j += nthreads) vis[j] = 0;
  if (tid == 0) {
    PL(uint8_t, F_ALIVE)[lane] = 0;
    PL(int32_t, F_STEPS)[lane] = 0;
    PL(int32_t, F_STATIC_PRUNED)[lane] = 0;
  }
}

// K12's order (mesh.py:83-110 rebalance): running lanes first, stable,
// then dealt round-robin: slot s * per + k takes packed lane k * n + s.
MT_DEV void mesh_deal_order(const Planes& P, int n, int32_t* packed, int32_t* order) {
  const int L = P.L, per = L / n;
  int front = 0;
  for (int l = 0; l < L; ++l) if (mesh_running(P, l)) packed[front++] = l;
  for (int l = 0; l < L; ++l) if (!mesh_running(P, l)) packed[front++] = l;
  for (int s = 0; s < n; ++s)
    for (int k = 0; k < per; ++k) order[s * per + k] = packed[k * n + s];
}
