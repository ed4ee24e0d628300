// K5's per-instance logic: the batched 3-CNF decider of
// mythril_tpu/laser/tpu/solver_jax.py:457 _solve_kernel, one instance per
// block. The block's whole program is solve_block, a template over the
// block it runs on: on the card (solve.cu) each thread runs it, and a
// part (blk.each) is that thread's share; in the host emulation
// (host_emu.cpp, -DMT_HOST_EMU) it runs once, and at each barrier every
// thread in turn runs its parts since the last one, ascending or
// descending. The barriers are blk.sync() and blk.sync_or(part)
// (__syncthreads_or of the part's result on the card), so the emulation
// runs the kernel's own sequence. A part may run after the template has
// left its scope (the emulation holds it to the next barrier), so a part
// that is not followed by a barrier at once captures by value.
//
// Semantics (the twin, laser/cuda/solver.py solve_plain, is the contract):
// phase 1 is Jacobi unit propagation -- every sweep reads the values of
// the previous sweep, the forces of one sweep are folded with max (1 beats
// -1), and the instance stops at its own fixpoint or its own conflict.
// Phase 2 (only while UNKNOWN and flips > 0) is one step per iteration:
// status update from the values at the start of the step, one unit-force
// sweep, a decision only when quiescent (the lowest-index unassigned var,
// input bits first; warm phase while steps < flips/4, else a random bit),
// and a restart from the phase-1 fixpoint on a conflict.
//
// Layout. The clause list is loaded once per instance: cp.async copies
// chunks of up to 4 raw clauses a thread (12 bytes each, 16-byte copies
// where the rows allow, else 4-byte ones; the whole list in one chunk
// where it fits) into a two-buffer stage in shared memory, the next
// chunk in flight while the block packs the current one
// into three int16 lists (lit[k][c], clamped to [-V, V]: the clamp of
// the twin's var index, so V <= 32767). With the per-variable arrays
// (val, fixed, warm, is_input: a byte each; upd: 4 bytes) everything a
// sweep reads is in shared memory.
//
// A sweep is two barriers. The clause pass (thread t: clauses t, t + n,
// ...) folds unit forces into upd with a shared atomicMax and ends in
// sync_or(dead); a thread that saw an unsatisfied real clause stores the
// sweep's stamp (its sweep count + 1) into notsat first, so no thread
// resets a flag. The variable pass (thread t: vars t, t + n, ...) applies
// upd, or on a phase-2 conflict restores the fixpoint, takes each warp's
// lowest unassigned (input) var with __reduce_min_sync into one shared
// word a warp, and ends in sync_or(changed). The decision then reads the
// warps' words, a warp at a time (every thread computes the same var and
// phase); the var's owner stores it, and the next clause pass reads the
// pending decision from a register rather than from val (the owner's
// store races with that pass). Reads of notsat and of the warps' words
// fall between the barriers that order them against the next writes.
#pragma once
#include "common.cuh"

// smt/solver/pysat.py SAT, UNSAT, UNKNOWN
enum SolveStatus { S_SAT = 10, S_UNSAT = 20, S_UNKNOWN = 0 };

#define SOLVE_MAX_THREADS 1024
#define SOLVE_MAX_WARPS (SOLVE_MAX_THREADS / 32)
#define SOLVE_MAX_VARS 32767  // |lit| <= V in an int16

#ifdef MT_HOST_EMU
#include <string.h>
#define MT_ATOMIC_MAX(p, v) (*(p) = (*(p) > (v) ? *(p) : (v)))
#else
#define MT_ATOMIC_MAX(p, v) atomicMax((p), (v))
#endif

// the decision phase's random bit: a 32-bit mix of (seed, instance, step)
MT_DEV uint32_t solve_mix32(uint32_t seed, uint32_t inst, uint32_t step) {
  uint32_t h = seed * 0x9E3779B1u + inst * 0x85EBCA77u + step * 0xC2B2AE3Du;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// the launch's arguments (I instances of C clauses over V vars)
struct SolveArgs {
  const int32_t* lits;      // [I, C, 3]
  const int32_t* nvars;     // [I]
  const uint8_t* is_input;  // [I, V]
  const int8_t* warm;       // [I, V]
  int32_t* status;          // [I]
  uint8_t* assign;          // [I, V]
  int32_t* sweeps;          // [I]
  int C, V, flips;
  uint32_t seed;
  int vec16;  // the clause rows take 16-byte copies (base 16-aligned, C % 4 == 0)
};

// the block's dynamic shared memory, carved by solve_carve
struct SolveSmem {
  int32_t* stage;  // 2 buffers of a chunk's raw clauses (one when one chunk holds them all)
  int32_t* upd;    // [V] the sweep's forces (-2: none)
  int16_t* lit[3];
  int8_t* val;     // [V] -1, 0, 1
  int8_t* fixed;   // [V] the phase-1 fixpoint
  int8_t* warm;    // [V]
  uint8_t* inp;    // [V]
};

// the block's static shared memory
struct SolveShared {
  int32_t notsat;                   // stamp of the last sweep that saw an unsatisfied real clause
  int32_t wmin[2][SOLVE_MAX_WARPS];  // per warp: lowest unassigned input var, lowest unassigned var (V: none)
};

MT_HD int64_t solve_round(int64_t x, int64_t to) { return (x + to - 1) / to * to; }

// bytes of dynamic shared memory for C clauses over V vars, loaded in
// chunks of ch clauses (carve order: stage, upd, lit, the byte arrays)
MT_HD int64_t solve_smem_for(int C, int V, int ch) {
  const int64_t nch = ch ? (C + ch - 1) / ch : 0, nbuf = nch > 1 ? 2 : nch;
  return nbuf * solve_round((int64_t)ch * 12, 16) + 4 * solve_round(V, 16) + 3 * 2 * solve_round(C, 8) +
         4 * solve_round(V, 16);
}

// clauses a load chunk takes: 4, 2 or 1 a thread, the most that fit a
// block's 227 KB beside the rest (all C where they fit in one chunk)
MT_HD int solve_chunk(int C, int V, int nthreads) {
  int ch = C;
  for (int m = 4; m >= 1; m >>= 1) {
    ch = C < m * nthreads ? C : m * nthreads;
    if (solve_smem_for(C, V, ch) + (int64_t)sizeof(SolveShared) <= 232448) break;
  }
  return ch;
}

MT_HD int64_t solve_smem_bytes(int C, int V, int nthreads) {
  return solve_smem_for(C, V, solve_chunk(C, V, nthreads));
}

MT_DEV SolveSmem solve_carve(uint8_t* base, int C, int V, int ch) {
  SolveSmem s;
  const int64_t nch = ch ? (C + ch - 1) / ch : 0, nbuf = nch > 1 ? 2 : nch;
  const int64_t Vp = solve_round(V, 16), Cp = solve_round(C, 8);
  uint8_t* p = base;
  s.stage = (int32_t*)p;
  p += nbuf * solve_round((int64_t)ch * 12, 16);
  s.upd = (int32_t*)p;
  p += 4 * Vp;
  for (int k = 0; k < 3; ++k, p += 2 * Cp) s.lit[k] = (int16_t*)p;
  s.val = (int8_t*)p;
  s.fixed = s.val + Vp;
  s.warm = s.fixed + Vp;
  s.inp = (uint8_t*)(s.warm + Vp);
  return s;
}

// cp.async: 16 or 4 bytes from device to shared memory, commit, wait
#ifdef MT_HOST_EMU
MT_DEV void solve_cp(void* dst, const void* src, int bytes) { memcpy(dst, src, bytes); }
MT_DEV void solve_cp_commit() {}
MT_DEV void solve_cp_wait(bool one_in_flight) { (void)one_in_flight; }
#else
__device__ __forceinline__ void solve_cp(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void solve_cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void solve_cp_wait(bool one_in_flight) {
  if (one_in_flight) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
#endif

// thread t: its vars' initial values and the instance's input bits and
// warm phases into shared memory; thread 0 clears the notsat stamp
MT_DEV void solve_init(const SolveArgs& a, const SolveSmem& s, SolveShared& sh, int inst, int t, int n) {
  for (int v = t; v < a.V; v += n) {
    s.val[v] = 0;
    s.upd[v] = -2;
    s.warm[v] = a.warm[(int64_t)inst * a.V + v];
    s.inp[v] = a.is_input[(int64_t)inst * a.V + v];
  }
  if (t == 0) sh.notsat = 0;
}

// thread t: its copies of chunk k (clauses k ch .. k ch + ch - 1) into
// stage buffer k & 1
MT_DEV void solve_issue(const SolveArgs& a, const SolveSmem& s, int inst, int ch, int k, int t, int n) {
  const int c0 = k * ch, nc = a.C - c0 < ch ? a.C - c0 : ch;
  const uint8_t* src = (const uint8_t*)(a.lits + ((int64_t)inst * a.C + c0) * 3);
  uint8_t* dst = (uint8_t*)s.stage + (k & 1) * solve_round((int64_t)ch * 12, 16);
  const int w = a.vec16 ? 16 : 4, units = nc * 12 / w;
  for (int u = t; u < units; u += n) solve_cp(dst + u * w, src + u * w, w);
  solve_cp_commit();
}

// thread t: clauses k ch + t, k ch + t + n, ... of chunk k from stage
// buffer k & 1 into the int16 lists
MT_DEV void solve_pack(const SolveArgs& a, const SolveSmem& s, int ch, int k, int t, int n) {
  const int32_t* stage = (const int32_t*)((const uint8_t*)s.stage + (k & 1) * solve_round((int64_t)ch * 12, 16));
  const int c0 = k * ch, c1 = a.C < c0 + ch ? a.C : c0 + ch;
  for (int c = c0 + t; c < c1; c += n) {
    const int32_t* raw = stage + (c - c0) * 3;
    for (int j = 0; j < 3; ++j) {
      const int32_t lit = raw[j];
      s.lit[j][c] = (int16_t)(lit > a.V ? a.V : (lit < -a.V ? -a.V : lit));
    }
  }
}

// The clause pass, thread t: each clause's unit force into upd (the
// first unknown literal's sign, folded with max); with a pending decision
// (pend < V) its var reads pend_phase. Stamps notsat; returns whether a
// clause of its share has every literal false.
MT_DEV bool solve_clauses(const SolveArgs& a, const SolveSmem& s, SolveShared& sh, int stamp, int pend,
                          int pend_phase, int t, int n) {
  bool dead = false, notsat = false;
  for (int c = t; c < a.C; c += n) {
    bool real = false, sat = false;
    int n_unknown = 0, unk_lit = 0;
    for (int k = 0; k < 3; ++k) {
      const int lit = s.lit[k][c];
      if (lit == 0) continue;
      real = true;
      const int v = (lit > 0 ? lit : -lit) - 1;
      const int x = v == pend ? pend_phase : s.val[v];
      const int lv = lit > 0 ? x : -x;
      if (lv == 1) sat = true;
      if (lv == 0) {
        if (n_unknown == 0) unk_lit = lit;  // first unknown literal (argmax)
        ++n_unknown;
      }
    }
    if (!real || sat) continue;
    notsat = true;
    if (n_unknown == 0) {
      dead = true;
    } else if (n_unknown == 1) {
      const int v = (unk_lit > 0 ? unk_lit : -unk_lit) - 1;
      MT_ATOMIC_MAX(&s.upd[v], unk_lit > 0 ? 1 : -1);
    }
  }
  if (notsat) sh.notsat = stamp;
  return dead;
}

// The variable pass, thread t: apply the forces (or, on a phase-2
// conflict, restore the fixpoint) and clear upd; with ``mins``, its
// warp's lowest unassigned var and input var (below nv) into sh.wmin.
// Returns whether it assigned a var.
template <class B>
MT_DEV bool solve_vars(B& blk, const SolveArgs& a, const SolveSmem& s, SolveShared& sh, bool restart, bool mins,
                       int nv, int t, int n) {
  bool changed = false;
  int mn_in = a.V, mn_any = a.V;
  for (int v = t; v < a.V; v += n) {
    if (restart) {
      s.val[v] = s.fixed[v];
      s.upd[v] = -2;
      continue;
    }
    int x = s.val[v];
    if (x == 0 && s.upd[v] > -2) {
      x = s.upd[v];
      s.val[v] = (int8_t)x;
      changed = true;
    }
    s.upd[v] = -2;
    if (x == 0 && v < nv) {
      mn_any = v < mn_any ? v : mn_any;
      if (s.inp[v]) mn_in = v < mn_in ? v : mn_in;
    }
  }
  if (mins) {
    blk.warp_min(sh.wmin[0], mn_in, t);
    blk.warp_min(sh.wmin[1], mn_any, t);
  }
  return changed;
}

// thread t: the restart point, then the warm seed of its vars
MT_DEV void solve_seed(const SolveArgs& a, const SolveSmem& s, int nv, int t, int n) {
  for (int v = t; v < a.V; v += n) {
    s.fixed[v] = s.val[v];
    if (s.val[v] == 0 && v < nv && s.warm[v] != 0) s.val[v] = s.warm[v];
  }
}

// Solve instance ``inst`` on block ``blk`` of n threads: status, the
// assignment row and the sweeps taken (phase-1 sweeps + phase-2 steps).
template <class B>
MT_DEV void solve_block(B& blk, const SolveArgs& a, const SolveSmem& s, SolveShared& sh, int inst) {
  const int n = blk.n, V = a.V, nv = a.nvars[inst], ch = solve_chunk(a.C, V, n);
  const int nch = ch ? (a.C + ch - 1) / ch : 0;
  // ---- the load: chunk k + 1 in flight while chunk k is packed
  blk.each([&](int t) {
    if (nch) solve_issue(a, s, inst, ch, 0, t, n);
    solve_init(a, s, sh, inst, t, n);  // while chunk 0 is in flight
  });
  for (int k = 0; k < nch; ++k) {
    blk.each([&](int t) {
      if (k + 1 < nch) solve_issue(a, s, inst, ch, k + 1, t, n);
      solve_cp_wait(k + 1 < nch);
    });
    blk.sync();  // chunk k in the stage
    blk.each([&](int t) { solve_pack(a, s, ch, k, t, n); });
    blk.sync();  // chunk k packed: its buffer may take chunk k + 2
  }
  if (!nch) blk.sync();
  int nsw = 0;
  bool conflict = false, allsat = false;
  // ---- phase 1: Jacobi unit propagation to this instance's fixpoint
  for (;;) {
    const int stamp = nsw + 1;
    const bool dead = blk.sync_or([&](int t) { return solve_clauses(a, s, sh, stamp, V, 0, t, n); });
    allsat = sh.notsat != stamp;  // at the fixpoint this is the fixpoint's verdict
    const bool changed = blk.sync_or([&](int t) { return solve_vars(blk, a, s, sh, false, false, nv, t, n); });
    ++nsw;
    if (dead) conflict = true;
    if (!changed || conflict) break;
  }
  int st = conflict ? S_UNSAT : (allsat ? S_SAT : S_UNKNOWN);
  // ---- the restart point, then the warm seed (every instance)
  blk.each([&](int t) { solve_seed(a, s, nv, t, n); });
  blk.sync();
  // ---- phase 2
  int pend = V, pend_phase = 0;
  for (int step = 0; st == S_UNKNOWN && step < a.flips; ++step) {
    const int stamp = nsw + 1;
    const bool dead =
        blk.sync_or([&](int t) { return solve_clauses(a, s, sh, stamp, pend, pend_phase, t, n); });
    const bool notsat = sh.notsat == stamp;
    const bool changed = blk.sync_or([&](int t) { return solve_vars(blk, a, s, sh, dead, true, nv, t, n); });
    ++nsw;
    pend = V;
    if (!notsat && !dead) st = S_SAT;
    if (st == S_UNKNOWN && !dead && !changed) {
      const int min_in = blk.block_min(sh.wmin[0]), min_any = blk.block_min(sh.wmin[1]);
      if (min_any < V) {
        const int dvar = min_in < V ? min_in : min_any;
        int phase = (solve_mix32(a.seed, (uint32_t)inst, (uint32_t)step) & 1u) ? 1 : -1;
        if (s.warm[dvar] != 0 && step < a.flips / 4) phase = s.warm[dvar];
        pend = dvar;
        pend_phase = phase;
        int8_t* val = s.val;
        blk.each([=](int t) {  // no barrier: the next clause pass reads pend instead
          if (dvar % n == t) val[dvar] = (int8_t)phase;
        });
      }
    }
  }
  const SolveArgs out = a;
  const int8_t* val = s.val;
  blk.each([=](int t) {
    for (int v = t; v < V; v += n) out.assign[(int64_t)inst * V + v] = val[v] > 0 ? 1 : 0;
    if (t == 0) {
      out.status[inst] = st;
      out.sweeps[inst] = nsw;
    }
  });
}
