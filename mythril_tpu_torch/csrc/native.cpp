// Native host engine for mythril_tpu_torch: keccak256 + a CDCL SAT solver.
//
// This supplies the native components the reference gets from pip wheels:
// the Z3 C++ solver (setup.py:30) is replaced by the in-repo CDCL core below
// (driven by the Python bit-blaster in mythril_tpu_torch/smt/solver/bitblast.py),
// and the _pysha3 keccak C extension by mtpu_keccak256.
//
// Build: g++ -O3 -shared -fPIC -o _mythril_native.so native.cpp
// Loaded via ctypes (mythril_tpu_torch/support/native_build.py). No pybind11 —
// plain C ABI.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <chrono>
#include <algorithm>

// ---------------------------------------------------------------------------
// keccak256 (Ethereum flavor: pad 0x01)

static const uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static inline uint64_t rotl64(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}

static void keccak_f1600(uint64_t st[25]) {
  static const int rot[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                              25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  static const int pi[25] = {0,  6,  12, 18, 24, 3,  9,  10, 16, 22, 1,  7,  13,
                             19, 20, 4,  5,  11, 17, 23, 2,  8,  14, 15, 21};
  uint64_t bc[5], t;
  for (int round = 0; round < 24; ++round) {
    // theta
    for (int i = 0; i < 5; ++i)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; ++i) {
      t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    // rho + pi  (x + 5y indexing)
    uint64_t b[25];
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y) {
        int src = x + 5 * y;
        int dst = y + 5 * ((2 * x + 3 * y) % 5);
        int r;
        {
          // rotation offsets table is for (x, y) of the source
          static const int offsets[5][5] = {{0, 36, 3, 41, 18},
                                            {1, 44, 10, 45, 2},
                                            {62, 6, 43, 15, 61},
                                            {28, 55, 25, 21, 56},
                                            {27, 20, 39, 8, 14}};
          r = offsets[x][y];
        }
        b[dst] = r ? rotl64(st[src], r) : st[src];
      }
    // chi
    for (int y = 0; y < 25; y += 5)
      for (int x = 0; x < 5; ++x)
        st[y + x] = b[y + x] ^ ((~b[y + (x + 1) % 5]) & b[y + (x + 2) % 5]);
    // iota
    st[0] ^= KECCAK_RC[round];
  }
  (void)rot;
  (void)pi;
}

extern "C" void mtpu_keccak256(const char* data, size_t len, char* out32) {
  const size_t rate = 136;
  uint64_t st[25];
  memset(st, 0, sizeof(st));
  size_t off = 0;
  // full blocks
  while (len - off >= rate) {
    for (size_t i = 0; i < rate / 8; ++i) {
      uint64_t lane;
      memcpy(&lane, data + off + i * 8, 8);
      st[i] ^= lane;
    }
    keccak_f1600(st);
    off += rate;
  }
  // final partial block with pad
  unsigned char block[136];
  memset(block, 0, sizeof(block));
  memcpy(block, data + off, len - off);
  block[len - off] ^= 0x01;
  block[rate - 1] ^= 0x80;
  for (size_t i = 0; i < rate / 8; ++i) {
    uint64_t lane;
    memcpy(&lane, block + i * 8, 8);
    st[i] ^= lane;
  }
  keccak_f1600(st);
  memcpy(out32, st, 32);
}

// ---------------------------------------------------------------------------
// CDCL SAT solver (two-watched literals, VSIDS, 1UIP, Luby restarts,
// incremental solving under assumptions, clause DB reduction by LBD).

namespace tsat {

typedef int Lit;  // signed DIMACS literal

struct Clause {
  std::vector<Lit> lits;
  bool learnt;
  unsigned lbd;
  double activity;
};

struct Solver {
  int nvars = 0;
  std::vector<Clause> clauses;
  std::vector<std::vector<int>> watches;  // index by lit encoding
  std::vector<int8_t> assign;             // var -> 0/1/-1
  std::vector<int> level;
  std::vector<int> reason;                // clause idx or -1
  std::vector<double> activity;
  std::vector<int8_t> phase;
  std::vector<Lit> trail;
  std::vector<int> trail_lim;
  size_t qhead = 0;
  double var_inc = 1.0;
  double cla_inc = 1.0;
  bool ok = true;
  std::vector<int> seen;
  // VSIDS decision order: indexed binary max-heap on activity with lazy
  // deletion (the sort-based order this replaced re-sorted EVERY var on
  // the first decide after any bump — O(n log n) per conflict, ~2M
  // comparisons each on the 100k-var instances witness queries build;
  // the heap makes it O(log n) per bumped var)
  std::vector<int> heap;      // heap array of var indices
  std::vector<int> heap_pos;  // var -> heap slot, -1 if absent
  // cooperative cancellation for portfolio/deadline use; set from any
  // thread via tsat_interrupt, polled once per conflict and every 1024
  // decisions (the old every-64-conflicts poll made slices unreliable
  // on propagation-heavy phases)
  std::atomic<bool> interrupted{false};
  // assumption-prefix trail reuse: after a SAT exit the assumption
  // decisions (levels 1..n) and everything they propagated stay on the
  // trail; the next solve keeps the longest still-valid shared prefix
  // instead of re-propagating from scratch. Minimize/CEGAR probe
  // sequences re-solve with near-identical assumption sets and no new
  // clauses, so whole prefixes survive. Any clause addition invalidates
  // the cached trail (trail_dirty).
  std::vector<Lit> last_assumptions;
  bool trail_dirty = true;

  int lit_index(Lit l) const { return l > 0 ? 2 * l : 2 * (-l) + 1; }

  bool heap_lt(int a, int b) const { return activity[a] > activity[b]; }

  void heap_up(int i) {
    int v = heap[i];
    while (i > 0) {
      int p = (i - 1) >> 1;
      if (!heap_lt(v, heap[p])) break;
      heap[i] = heap[p];
      heap_pos[heap[i]] = i;
      i = p;
    }
    heap[i] = v;
    heap_pos[v] = i;
  }

  void heap_down(int i) {
    int v = heap[i];
    const int n = (int)heap.size();
    for (;;) {
      int l = 2 * i + 1;
      if (l >= n) break;
      int c = (l + 1 < n && heap_lt(heap[l + 1], heap[l])) ? l + 1 : l;
      if (!heap_lt(heap[c], v)) break;
      heap[i] = heap[c];
      heap_pos[heap[i]] = i;
      i = c;
    }
    heap[i] = v;
    heap_pos[v] = i;
  }

  void heap_insert(int v) {
    if (heap_pos[v] != -1) return;
    heap_pos[v] = (int)heap.size();
    heap.push_back(v);
    heap_up(heap_pos[v]);
  }

  int heap_pop() {
    int v = heap[0];
    heap_pos[v] = -1;
    int last = heap.back();
    heap.pop_back();
    if (!heap.empty()) {
      heap[0] = last;
      heap_pos[last] = 0;
      heap_down(0);
    }
    return v;
  }

  int new_var() {
    ++nvars;
    assign.push_back(0);
    level.push_back(0);
    reason.push_back(-1);
    activity.push_back(0.0);
    phase.push_back(-1);
    seen.push_back(0);
    watches.resize(2 * nvars + 2);
    heap_pos.push_back(-1);
    heap_insert(nvars - 1);
    return nvars;
  }

  void ensure_var(int v) {
    while (nvars < v) new_var();
  }

  int value(Lit l) const {
    int8_t v = assign[std::abs(l) - 1];
    return l > 0 ? v : -v;
  }

  void enqueue(Lit l, int why) {
    int v = std::abs(l) - 1;
    assign[v] = l > 0 ? 1 : -1;
    level[v] = (int)trail_lim.size();
    reason[v] = why;
    phase[v] = l > 0 ? 1 : -1;
    trail.push_back(l);
  }

  void attach(int ci) {
    Clause& c = clauses[ci];
    watches[lit_index(c.lits[0])].push_back(ci);
    watches[lit_index(c.lits[1])].push_back(ci);
  }

  void cancel_until(int lvl) {
    while ((int)trail_lim.size() > lvl) {
      int lim = trail_lim.back();
      trail_lim.pop_back();
      for (size_t i = lim; i < trail.size(); ++i) {
        int v = std::abs(trail[i]) - 1;
        assign[v] = 0;
        reason[v] = -1;
        heap_insert(v);  // unassigned vars must be decidable again
      }
      trail.resize(lim);
    }
    if (qhead > trail.size()) qhead = trail.size();
  }

  bool root_assign(Lit l) {
    if (value(l) == -1) return false;
    if (value(l) == 1) return true;
    enqueue(l, -1);
    return propagate() == -1;
  }

  void add_clause(const Lit* lits, int n) {
    if (!ok) return;
    trail_dirty = true;
    cancel_until(0);
    std::vector<Lit> c;
    c.reserve(n);
    for (int i = 0; i < n; ++i) {
      Lit l = lits[i];
      ensure_var(std::abs(l));
      bool dup = false, taut = false;
      for (Lit o : c) {
        if (o == l) dup = true;
        if (o == -l) taut = true;
      }
      if (taut) return;
      if (dup) continue;
      if (value(l) == 1) return;
      if (value(l) == -1) continue;
      c.push_back(l);
    }
    if (c.empty()) {
      ok = false;
      return;
    }
    if (c.size() == 1) {
      if (!root_assign(c[0])) ok = false;
      return;
    }
    clauses.push_back({c, false, 0, 0.0});
    attach((int)clauses.size() - 1);
  }

  int propagate() {
    while (qhead < trail.size()) {
      Lit l = trail[qhead++];
      Lit fl = -l;
      std::vector<int>& wl = watches[lit_index(fl)];
      size_t i = 0;
      while (i < wl.size()) {
        int ci = wl[i];
        Clause& c = clauses[ci];
        if (c.lits[0] == fl) std::swap(c.lits[0], c.lits[1]);
        Lit first = c.lits[0];
        if (value(first) == 1) {
          ++i;
          continue;
        }
        bool moved = false;
        for (size_t k = 2; k < c.lits.size(); ++k) {
          if (value(c.lits[k]) != -1) {
            std::swap(c.lits[1], c.lits[k]);
            watches[lit_index(c.lits[1])].push_back(ci);
            wl[i] = wl.back();
            wl.pop_back();
            moved = true;
            break;
          }
        }
        if (moved) continue;
        if (value(first) == -1) {
          qhead = trail.size();
          return ci;
        }
        enqueue(first, ci);
        ++i;
      }
    }
    return -1;
  }

  void bump_var(int v) {
    activity[v] += var_inc;
    if (activity[v] > 1e100) {
      // uniform rescale preserves relative order: heap invariant holds
      for (int u = 0; u < nvars; ++u) activity[u] *= 1e-100;
      var_inc *= 1e-100;
    }
    if (heap_pos[v] != -1) heap_up(heap_pos[v]);
  }

  void analyze(int confl, std::vector<Lit>& learnt, int& bt_level, unsigned& lbd) {
    learnt.clear();
    learnt.push_back(0);
    int counter = 0;
    Lit asserting = 0;
    int index = (int)trail.size() - 1;
    int cur_level = (int)trail_lim.size();
    for (;;) {
      Clause& c = clauses[confl];
      if (c.learnt) bump_clause(confl);
      for (Lit q : c.lits) {
        if (q == asserting) continue;
        int v = std::abs(q) - 1;
        if (!seen[v] && level[v] > 0) {
          seen[v] = 1;
          bump_var(v);
          if (level[v] >= cur_level)
            ++counter;
          else
            learnt.push_back(q);
        }
      }
      while (!seen[std::abs(trail[index]) - 1]) --index;
      asserting = trail[index--];
      int v = std::abs(asserting) - 1;
      seen[v] = 0;
      if (--counter == 0) {
        learnt[0] = -asserting;
        break;
      }
      confl = reason[v];
    }
    for (size_t i = 1; i < learnt.size(); ++i) seen[std::abs(learnt[i]) - 1] = 0;
    // backtrack level + move second watch
    if (learnt.size() == 1) {
      bt_level = 0;
    } else {
      size_t max_i = 1;
      for (size_t i = 2; i < learnt.size(); ++i)
        if (level[std::abs(learnt[i]) - 1] > level[std::abs(learnt[max_i]) - 1])
          max_i = i;
      std::swap(learnt[1], learnt[max_i]);
      bt_level = level[std::abs(learnt[1]) - 1];
    }
    // LBD
    lbd = 0;
    std::vector<int> lvls;
    for (Lit q : learnt) {
      int lv = level[std::abs(q) - 1];
      if (std::find(lvls.begin(), lvls.end(), lv) == lvls.end()) {
        lvls.push_back(lv);
        ++lbd;
      }
    }
  }

  void bump_clause(int ci) {
    Clause& c = clauses[ci];
    c.activity += cla_inc;
    if (c.activity > 1e20) {
      for (Clause& cl : clauses)
        if (cl.learnt) cl.activity *= 1e-20;
      cla_inc *= 1e-20;
    }
  }

  Lit decide() {
    // lazy deletion: assigned vars surface and get dropped; they
    // re-enter the heap when cancel_until unassigns them
    while (!heap.empty()) {
      int v = heap_pop();
      if (assign[v] == 0) return phase[v] >= 0 ? (v + 1) : -(v + 1);
    }
    // safety net (every unassigned var should be heap-resident): a full
    // scan so an invariant slip degrades to slow, never to a bogus SAT
    for (int v = 0; v < nvars; ++v)
      if (assign[v] == 0) return phase[v] >= 0 ? (v + 1) : -(v + 1);
    return 0;
  }

  void reduce_db() {
    // drop half of the high-LBD learnt clauses
    std::vector<int> learnt_idx;
    for (int i = 0; i < (int)clauses.size(); ++i)
      if (clauses[i].learnt && clauses[i].lits.size() > 2) learnt_idx.push_back(i);
    if (learnt_idx.size() < 2000) return;
    std::sort(learnt_idx.begin(), learnt_idx.end(), [this](int a, int b) {
      if (clauses[a].lbd != clauses[b].lbd) return clauses[a].lbd < clauses[b].lbd;
      return clauses[a].activity > clauses[b].activity;
    });
    std::vector<char> drop(clauses.size(), 0);
    for (size_t i = learnt_idx.size() / 2; i < learnt_idx.size(); ++i) {
      int ci = learnt_idx[i];
      // keep reason clauses
      bool is_reason = false;
      for (Lit l : clauses[ci].lits) {
        int v = std::abs(l) - 1;
        if (assign[v] != 0 && reason[v] == ci) {
          is_reason = true;
          break;
        }
      }
      if (!is_reason) drop[ci] = 1;
    }
    // rebuild watches without dropped clauses; mark dropped as empty
    for (auto& wl : watches) {
      size_t j = 0;
      for (size_t i = 0; i < wl.size(); ++i)
        if (!drop[wl[i]]) wl[j++] = wl[i];
      wl.resize(j);
    }
    for (size_t i = 0; i < clauses.size(); ++i)
      if (drop[i]) {
        clauses[i].lits.clear();
        clauses[i].lits.shrink_to_fit();
      }
  }

  static long long luby(int x) {
    // canonical iterative Luby sequence, x >= 0: 1,1,2,1,1,2,4,...
    int size = 1, seq = 0;
    while (size < x + 1) {
      ++seq;
      size = 2 * size + 1;
    }
    while (size - 1 != x) {
      size = (size - 1) >> 1;
      --seq;
      x = x % size;
    }
    return 1LL << seq;
  }

  int solve(const Lit* assumptions, int n_assumptions, int timeout_ms,
            long long conflict_budget) {
    if (!ok) return 20;
    for (int i = 0; i < n_assumptions; ++i) ensure_var(std::abs(assumptions[i]));
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms > 0 ? timeout_ms : 1 << 30);
    long long conflicts = 0;
    long long decisions = 0;
    int restart_idx = 0;
    long long restart_limit = 64 * luby(restart_idx);
    long long next_reduce = 4000;
    // keep the longest assumption prefix whose decisions are still on
    // the trail from the previous (SAT-exited) solve; everything those
    // levels propagated is reused for free
    int keep = 0;
    if (!trail_dirty) {
      int bound = (int)trail_lim.size();
      if (n_assumptions < bound) bound = n_assumptions;
      if ((int)last_assumptions.size() < bound)
        bound = (int)last_assumptions.size();
      while (keep < bound && last_assumptions[keep] == assumptions[keep] &&
             value(assumptions[keep]) == 1)
        ++keep;
    }
    cancel_until(keep);
    trail_dirty = false;
    last_assumptions.assign(assumptions, assumptions + n_assumptions);
    if (propagate() != -1) {
      if (keep == 0) {
        ok = false;
        return 20;
      }
      // conflict under the reused prefix alone: fall back to a clean
      // root solve rather than reasoning about which level failed
      cancel_until(0);
      if (propagate() != -1) {
        ok = false;
        return 20;
      }
    }
    std::vector<Lit> learnt;
    for (;;) {
      int confl = propagate();
      if (confl != -1) {
        ++conflicts;
        if (trail_lim.empty()) {
          ok = false;
          return 20;
        }
        if ((int)trail_lim.size() <= n_assumptions) {
          cancel_until(0);
          return 20;
        }
        int bt;
        unsigned lbd;
        analyze(confl, learnt, bt, lbd);
        cancel_until(std::min(bt, (int)trail_lim.size() - 1));
        if (learnt.size() == 1) {
          if (trail_lim.empty()) {
            if (!root_assign(learnt[0])) {
              ok = false;
              return 20;
            }
          } else if (value(learnt[0]) == 0) {
            enqueue(learnt[0], -1);
          }
        } else {
          clauses.push_back({learnt, true, lbd, cla_inc});
          int ci = (int)clauses.size() - 1;
          attach(ci);
          if (value(learnt[0]) == 0) enqueue(learnt[0], ci);
        }
        var_inc /= 0.95;
        cla_inc /= 0.999;
        if (conflict_budget > 0 && conflicts > conflict_budget) {
          cancel_until(0);
          return 0;
        }
        // poll EVERY conflict: now() costs ~20ns against conflicts that
        // cost microseconds, and the old every-64 gate made deadlines
        // and interrupts unreliable on propagation-heavy stretches
        if (interrupted.load(std::memory_order_relaxed) ||
            std::chrono::steady_clock::now() > deadline) {
          cancel_until(0);
          return 0;
        }
        if (conflicts >= restart_limit) {
          ++restart_idx;
          restart_limit = conflicts + 64 * luby(restart_idx);
          cancel_until(0);
        }
        if (conflicts >= next_reduce) {
          next_reduce += 4000;
          reduce_db();
        }
      } else {
        if ((int)trail_lim.size() < n_assumptions) {
          Lit l = assumptions[trail_lim.size()];
          if (value(l) == -1) {
            cancel_until(0);
            return 20;
          }
          trail_lim.push_back((int)trail.size());
          if (value(l) == 0) enqueue(l, -1);
          continue;
        }
        Lit l = decide();
        if (l == 0) return 10;
        if ((++decisions & 1023) == 0 &&
            (interrupted.load(std::memory_order_relaxed) ||
             std::chrono::steady_clock::now() > deadline)) {
          cancel_until(0);
          return 0;
        }
        trail_lim.push_back((int)trail.size());
        enqueue(l, -1);
      }
    }
  }

  int model_value(int var) {
    if (var > nvars || assign[var - 1] == 0) return -1;
    return assign[var - 1];
  }
};

}  // namespace tsat

extern "C" {
void* tsat_new() { return new tsat::Solver(); }
void tsat_free(void* s) { delete (tsat::Solver*)s; }
int tsat_new_var(void* s) { return ((tsat::Solver*)s)->new_var(); }
void tsat_add_clause(void* s, const int* lits, int n) {
  ((tsat::Solver*)s)->add_clause(lits, n);
}
// Bulk interface: `flat` holds clauses separated by 0 sentinels. One ctypes
// crossing per batch instead of one per clause (the per-call marshalling cost
// dominated bit-blasting before this existed).
void tsat_add_clauses(void* s, const int* flat, int n) {
  auto* solver = (tsat::Solver*)s;
  const int* start = flat;
  for (int i = 0; i < n; i++) {
    if (flat[i] == 0) {
      solver->add_clause(start, (int)(flat + i - start));
      start = flat + i + 1;
    }
  }
}
void tsat_ensure_vars(void* s, int n) {
  auto* solver = (tsat::Solver*)s;
  while (solver->nvars < n) solver->new_var();
}
int tsat_solve(void* s, const int* assumptions, int n, int timeout_ms,
               long long conflict_budget) {
  return ((tsat::Solver*)s)->solve(assumptions, n, timeout_ms, conflict_budget);
}
int tsat_model_value(void* s, int var) {
  return ((tsat::Solver*)s)->model_value(var);
}
// Copy the whole assignment (1/-1/0 per var) in one crossing: out[v-1] holds
// var v's value. Model extraction over many variables was one ctypes call
// per bit before this existed.
void tsat_model_copy(void* s, signed char* out, int n) {
  auto* solver = (tsat::Solver*)s;
  int limit = n < solver->nvars ? n : solver->nvars;
  for (int v = 1; v <= limit; v++) out[v - 1] = (signed char)solver->assign[v - 1];
}
int tsat_ok(void* s) { return ((tsat::Solver*)s)->ok ? 1 : 0; }
// Cooperative cancellation: safe to call from any thread while another
// thread is inside tsat_solve; that solve returns 0 (UNKNOWN) at its
// next poll point (every conflict / every 1024 decisions). The flag
// stays set until cleared so a racing solve that starts late still
// stops promptly.
void tsat_interrupt(void* s) {
  ((tsat::Solver*)s)->interrupted.store(true, std::memory_order_relaxed);
}
void tsat_clear_interrupt(void* s) {
  ((tsat::Solver*)s)->interrupted.store(false, std::memory_order_relaxed);
}
// Decision-phase seeding (e.g. from the device solver's model): bias
// the saved phase so the first descent follows a known-good assignment.
void tsat_set_phase(void* s, int var, int sign) {
  auto* solver = (tsat::Solver*)s;
  if (var >= 1 && var <= solver->nvars)
    solver->phase[var - 1] = sign >= 0 ? 1 : -1;
}
}
