// Host emulation of the kernels' lane logic, for the CPU tests: the same
// headers compiled as plain C++ (-DMT_HOST_EMU), with loops over lanes
// standing in for the grids of step.cu, inloop.cu, megakernel.cu and
// keccak.cu. Built with g++ by tests/test_torch_kernel_logic.py; never
// used on the card.
#include <stdint.h>

#include "inloop.cuh"
#include "megakernel.cuh"
#include "step.cuh"

struct HostRow {
  const uint8_t* row;
  int avail;
  uint32_t operator()(int i) const { return i < avail ? row[i] : 0u; }
};

extern "C" {

// K1: plan, K2 over the SHA3 windows, lane pass, fork copies
int emu_step(const Planes* Pp, const Bank* Bp, const int32_t* tab, int32_t* slot, uint8_t* fork_do,
             int32_t* fork_dest, uint8_t* sha_active, int32_t* sha_off, int32_t* sha_avail,
             int32_t* sha_len, uint8_t* sha_digest) {
  const Planes& P = *Pp;
  const Bank& B = *Bp;
  if (P.L > 1024) return 1;
  uint8_t free_[1024], req[1024];
  int32_t rank[1024];
  for (int l = 0; l < P.L; ++l) {
    int dest;
    free_[l] = PL(uint8_t, F_ALIVE)[l] ? 0 : 1;
    req[l] = fork_base_of(P, B, tab, l, &dest) ? 1 : 0;
    sha_request(P, B, l, sha_active, sha_off, sha_avail, sha_len);
  }
  plan_assign(P.L, free_, req, slot, rank);
  for (int l = 0; l < P.L; ++l) {
    if (!sha_active[l]) continue;
    HostRow g{PL(uint8_t, F_MEMORY) + (int64_t)l * P.M + sha_off[l], sha_avail[l]};
    keccak256_padded(g, sha_len[l], (SHA_CAP + KECCAK_RATE) / KECCAK_RATE, sha_digest + l * 32);
  }
  for (int l = 0; l < P.L; ++l) step_lane(P, B, tab, slot, sha_digest, fork_do, fork_dest, l);
  for (int l = 0; l < P.L; ++l) {
    if (!fork_do[l]) continue;
    copy_row_part(P, P, l, slot[l], 0, 1);
    fork_child_edits(P, slot[l], fork_dest[l]);
  }
  return 0;
}

// K3
int emu_unsat(const Planes* P, const Pool* pool, uint8_t* out) {
  for (int l = 0; l < P->L; ++l) out[l] = unsat_lane(*P, *pool, l) ? 1 : 0;
  return 0;
}

// K4: plan, gather into scratch with folds, copy back, commit ctl
int emu_epilogue(const Planes* Pp, const Planes* Sp, const uint8_t* prune_revert,
                 const uint8_t* unsat, int32_t* acc, int32_t* order, uint8_t* dying, uint8_t* pv,
                 int32_t* ctl, int max_rounds) {
  const Planes& P = *Pp;
  const Planes& Sc = *Sp;
  if (P.L > 1024) return 1;
  if (!ctl[1]) return 0;
  uint8_t dead_s[1024], dying_s[1024];
  for (int l = 0; l < P.L; ++l) {
    bool dead;
    dying_s[l] = dying_of(P, prune_revert, unsat, l, &dead) ? 1 : 0;
    dead_s[l] = dead ? 1 : 0;
  }
  epi_plan_serial(P, dead_s, dying_s, acc, order, dying, ctl, max_rounds);
  for (int d = 0; d < P.L; ++d) copy_row_part(P, Sc, order[d], d, 0, 1);
  for (int d = 0; d < P.L; ++d) epi_fold_lane(P, Sc, order, dying, pv, d, 0, 1);
  for (int d = 0; d < P.L; ++d) copy_row_part(Sc, P, d, d, 0, 1);
  ctl[0] = ctl[2];
  ctl[1] = ctl[3];
  return 0;
}

// K2, flat rows
int emu_keccak(const uint8_t* data, const int32_t* length, uint8_t* out, int rows, int n,
               int max_blocks) {
  for (int r = 0; r < rows; ++r) {
    HostRow g{data + (int64_t)r * n, n};
    keccak256_padded(g, length[r], max_blocks, out + (int64_t)r * 32);
  }
  return 0;
}
}
