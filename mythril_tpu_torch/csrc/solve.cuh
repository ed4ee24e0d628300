// K5's per-instance logic: the batched 3-CNF decider of
// mythril_tpu/laser/tpu/solver_jax.py:457 _solve_kernel, one instance per
// block. Plain C++ over pointers: with MT_HOST_EMU the same function runs
// on the host with one "thread" (tid 0 of 1), where the barriers are
// no-ops and the block-wide reductions are plain stores.
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
#pragma once
#include "common.cuh"

// smt/solver/pysat.py SAT, UNSAT, UNKNOWN
enum SolveStatus { S_SAT = 10, S_UNSAT = 20, S_UNKNOWN = 0 };

#ifdef MT_HOST_EMU
#define MT_SYNC()
#define MT_ATOMIC_MAX(p, v) (*(p) = (*(p) > (v) ? *(p) : (v)))
#define MT_ATOMIC_MIN(p, v) (*(p) = (*(p) < (v) ? *(p) : (v)))
#else
#define MT_SYNC() __syncthreads()
#define MT_ATOMIC_MAX(p, v) atomicMax((p), (v))
#define MT_ATOMIC_MIN(p, v) atomicMin((p), (v))
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

// flags a block shares (shared memory on the card)
struct SolveFlags {
  int dead;     // some clause has every literal false
  int notsat;   // some real clause is not satisfied
  int changed;  // the sweep assigned a variable
  int min_in;   // lowest unassigned input var (V = none)
  int min_any;  // lowest unassigned var (V = none)
};

// One clause against val: contributes its unit force to upd and its
// dead / not-satisfied flags.
MT_DEV void solve_clause(const int32_t* cl, const int8_t* val, int V, int32_t* upd,
                         SolveFlags* f) {
  bool real = false, sat = false;
  int n_unknown = 0, unk_lit = 0;
  for (int k = 0; k < 3; ++k) {
    int lit = cl[k];
    if (lit == 0) continue;
    real = true;
    int v = (lit > 0 ? lit : -lit) - 1;
    v = v < 0 ? 0 : (v > V - 1 ? V - 1 : v);
    int x = val[v];
    int lv = lit > 0 ? x : -x;
    if (lv == 1) sat = true;
    if (lv == 0) {
      if (n_unknown == 0) unk_lit = lit;  // first unknown literal (argmax)
      ++n_unknown;
    }
  }
  if (!real || sat) return;
  f->notsat = 1;
  if (n_unknown == 0) {
    f->dead = 1;
  } else if (n_unknown == 1) {
    int v = (unk_lit > 0 ? unk_lit : -unk_lit) - 1;
    v = v < 0 ? 0 : (v > V - 1 ? V - 1 : v);
    MT_ATOMIC_MAX(&upd[v], unk_lit > 0 ? 1 : -1);
  }
}

// Solve instance ``inst``. ``val``/``fixed``/``upd`` are the block's
// scratch (V entries each), ``f`` its shared flags. Writes status, the
// assignment row and the sweeps taken (phase-1 sweeps + phase-2 steps).
MT_DEV void solve_instance(const int32_t* lits, const int32_t* nvars, const uint8_t* is_input,
                           const int8_t* warm, int32_t* status, uint8_t* assign,
                           int32_t* sweeps, int C, int V, int flips, uint32_t seed, int inst,
                           int8_t* val, int8_t* fixed, int32_t* upd, SolveFlags* f, int tid,
                           int nthreads) {
  const int32_t* L = lits + (int64_t)inst * C * 3;
  const uint8_t* inp = is_input + (int64_t)inst * V;
  const int8_t* wm = warm + (int64_t)inst * V;
  int nv = nvars[inst];
  for (int v = tid; v < V; v += nthreads) {
    val[v] = 0;
    upd[v] = -2;
  }
  MT_SYNC();
  int nsw = 0;
  bool conflict = false, allsat = false;
  // ---- phase 1: Jacobi unit propagation to this instance's fixpoint
  for (;;) {
    if (tid == 0) f->dead = f->notsat = f->changed = 0;
    MT_SYNC();
    for (int c = tid; c < C; c += nthreads) solve_clause(L + 3 * c, val, V, upd, f);
    MT_SYNC();
    for (int v = tid; v < V; v += nthreads) {
      if (val[v] == 0 && upd[v] > -2) {
        val[v] = (int8_t)upd[v];
        f->changed = 1;
      }
      upd[v] = -2;
    }
    MT_SYNC();
    int dead = f->dead, changed = f->changed;
    allsat = !f->notsat;  // at the fixpoint this is the fixpoint's verdict
    MT_SYNC();
    ++nsw;
    if (dead) conflict = true;
    if (!changed || conflict) break;
  }
  int st = conflict ? S_UNSAT : (allsat ? S_SAT : S_UNKNOWN);
  // ---- the restart point, then the warm seed (every instance)
  for (int v = tid; v < V; v += nthreads) {
    fixed[v] = val[v];
    if (val[v] == 0 && v < nv && wm[v] != 0) val[v] = wm[v];
  }
  MT_SYNC();
  // ---- phase 2
  for (int step = 0; st == S_UNKNOWN && step < flips; ++step) {
    if (tid == 0) {
      f->dead = f->notsat = f->changed = 0;
      f->min_in = f->min_any = V;
    }
    MT_SYNC();
    for (int c = tid; c < C; c += nthreads) solve_clause(L + 3 * c, val, V, upd, f);
    MT_SYNC();
    for (int v = tid; v < V; v += nthreads) {
      if (val[v] == 0 && upd[v] > -2) {
        val[v] = (int8_t)upd[v];
        f->changed = 1;
      }
      upd[v] = -2;
      if (val[v] == 0 && v < nv) {
        MT_ATOMIC_MIN(&f->min_any, v);
        if (inp[v]) MT_ATOMIC_MIN(&f->min_in, v);
      }
    }
    MT_SYNC();
    int dead = f->dead, changed = f->changed, notsat = f->notsat;
    int min_in = f->min_in, min_any = f->min_any;
    MT_SYNC();
    ++nsw;
    if (!notsat && !dead) st = S_SAT;
    if (st == S_UNKNOWN && !dead && !changed && min_any < V) {
      if (tid == 0) {
        int dvar = min_in < V ? min_in : min_any;
        int8_t phase = (solve_mix32(seed, (uint32_t)inst, (uint32_t)step) & 1u) ? 1 : -1;
        if (wm[dvar] != 0 && step < flips / 4) phase = wm[dvar];
        val[dvar] = phase;
      }
    } else if (st == S_UNKNOWN && dead) {
      for (int v = tid; v < V; v += nthreads) val[v] = fixed[v];
    }
    MT_SYNC();
  }
  for (int v = tid; v < V; v += nthreads) assign[(int64_t)inst * V + v] = val[v] > 0 ? 1 : 0;
  if (tid == 0) {
    status[inst] = st;
    sweeps[inst] = nsw;
  }
}
