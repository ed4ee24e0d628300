// A block-wide exclusive scan of per-lane flag bytes (bits 0-2, each
// counted separately), shared by K1's fork rank (step.cuh) and K4's
// compaction plan (megakernel.cuh). Every block of a launch scans all L
// flags in its own shared memory, so no grid barrier hands a prefix
// around. The scan is three parts split at __syncthreads(), each a
// function of (tid, nthreads) that the host emulation runs thread by
// thread: chunk sums, a Kogge-Stone scan of those within each warp (warp
// shuffles on the card, the same steps over an array on the host), and
// the per-lane prefixes. No thread walks more than ceil(L / nthreads)
// lanes. A segmented count (per contiguous lane block) is the global
// prefix minus its value at the block's first lane.
#pragma once
#include "common.cuh"

#define RANK_MAX_LANES 1024
#define RANK_MAX_THREADS 1024

// bit0 | bit1 << 16 | bit2 << 32 of a lane's flag byte: three counts of
// at most 1024 lanes in one word
MT_DEV uint64_t lf_count(uint8_t f) {
  return (uint64_t)(f & 1) | ((uint64_t)((f >> 1) & 1) << 16) | ((uint64_t)((f >> 2) & 1) << 32);
}
MT_DEV int lf_n0(uint64_t c) { return (int)(c & 0xFFFF); }
MT_DEV int lf_n1(uint64_t c) { return (int)((c >> 16) & 0xFFFF); }

struct RankShared {
  uint64_t part[RANK_MAX_THREADS];  // per thread: its chunk's counts, then their exclusive scan in its warp
  uint64_t wsum[RANK_MAX_THREADS / 32];  // per warp: its total
  uint64_t pre[RANK_MAX_LANES + 1];  // per lane: the counts over every lane before it; pre[L]: totals
};

MT_DEV void rank_chunk(int L, int tid, int nthreads, int* lo, int* hi) {
  int c = (L + nthreads - 1) / nthreads;
  *lo = tid * c < L ? tid * c : L;
  *hi = *lo + c < L ? *lo + c : L;
}

// part 1: each thread's chunk sum
MT_DEV void rank_sum_chunk(int L, const uint8_t* flags, RankShared& rs, int tid, int nthreads) {
  int lo, hi;
  rank_chunk(L, tid, nthreads, &lo, &hi);
  uint64_t s = 0;
  for (int l = lo; l < hi; ++l) s += lf_count(flags[l]);
  rs.part[tid] = s;
}

// part 2: exclusive scan of part[] within each warp, warp totals to wsum
#ifdef MT_HOST_EMU
static void rank_scan_warps(RankShared& rs, int nthreads) {
  for (int w = 0; w * 32 < nthreads; ++w) {
    uint64_t own[32], v[32], up[32];
    for (int i = 0; i < 32; ++i) own[i] = v[i] = rs.part[w * 32 + i];
    for (int d = 1; d < 32; d <<= 1) {  // __shfl_up_sync(v, d) on every lane at once
      for (int i = 0; i < 32; ++i) up[i] = i >= d ? v[i - d] : 0;
      for (int i = 0; i < 32; ++i) v[i] += up[i];
    }
    for (int i = 0; i < 32; ++i) rs.part[w * 32 + i] = v[i] - own[i];
    rs.wsum[w] = v[31];
  }
}
#else
__device__ __forceinline__ void rank_scan_warp(RankShared& rs, int tid) {
  const int wl = tid & 31;
  uint64_t own = rs.part[tid], v = own;
  for (int d = 1; d < 32; d <<= 1) {
    uint64_t up = __shfl_up_sync(0xffffffffu, (unsigned long long)v, d);
    if (wl >= d) v += up;
  }
  rs.part[tid] = v - own;
  if (wl == 31) rs.wsum[tid >> 5] = v;
}
#endif

// part 3: the per-lane exclusive prefixes; the last thread writes pre[L]
MT_DEV void rank_prefix(int L, const uint8_t* flags, RankShared& rs, int tid, int nthreads) {
  uint64_t x = rs.part[tid];
  for (int w = 0; w < (tid >> 5); ++w) x += rs.wsum[w];
  int lo, hi;
  rank_chunk(L, tid, nthreads, &lo, &hi);
  for (int l = lo; l < hi; ++l) {
    rs.pre[l] = x;
    x += lf_count(flags[l]);
  }
  if (tid == nthreads - 1) rs.pre[L] = x;
}

// after part 3: whether any lane has bit 2 set (K1, K4: a running lane)
MT_DEV bool rank_any_running(const RankShared& rs, int L) { return (rs.pre[L] >> 32) != 0; }
