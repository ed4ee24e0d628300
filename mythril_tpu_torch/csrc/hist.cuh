// The retired-opcode histogram's lane logic (mythril_tpu/laser/tpu/
// engine.py:1398 op_hist_update), shared by K8 (hist.cu, one step given
// as two snapshots) and by K1 with stats (step.cu, every step of its
// launch). A lane retired code[before.code_id, clip(before.pc)] iff its
// step counter advanced (signed compare); every other lane lands in bin
// 256, which is dropped. The code row is read as JAX's gather reads it:
// a negative id wraps once (adds n_codes), then clamps into
// [0, n_codes - 1].
#pragma once
#include "common.cuh"

#define HIST_BINS 256

#ifdef MT_HOST_EMU
#define MT_ATOMIC_ADD_U32(p, v) (*(p) += (v))
#else
#define MT_ATOMIC_ADD_U32(p, v) atomicAdd((p), (v))
#endif

// the opcode byte a lane at (code_id, pc) would retire
MT_DEV int hist_op(const uint8_t* code, int n_codes, int CL, int32_t code_id, int32_t pc) {
  int row = code_id < 0 ? code_id + n_codes : code_id;
  row = row < 0 ? 0 : (row > n_codes - 1 ? n_codes - 1 : row);
  int col = pc < 0 ? 0 : (pc > CL - 1 ? CL - 1 : pc);
  return code[(int64_t)row * CL + col];
}

MT_DEV int hist_bin(const uint8_t* code, int n_codes, int CL, int32_t code_id, int32_t pc,
                    int32_t steps_before, int32_t steps_after) {
  if (!(steps_after > steps_before)) return HIST_BINS;
  return hist_op(code, n_codes, CL, code_id, pc);
}

// ---- K1 with stats. rec is int32[2L], per-lane scratch: rec[l] the
// opcode lane l would retire and rec[L + l] its steps, both taken from
// the pre-step row before the step's lane pass runs. That is every lane's
// own row, a free lane's stale one included: a fork child landing there
// counts that row's opcode iff the parent's post-step steps exceed the
// row's stale steps, as the reference's whole-batch compare has it.

MT_DEV void hist_record(const Planes& P, const uint8_t* code, int32_t* rec, int l) {
  rec[l] = hist_op(code, P.n_codes, P.CL, PL(int32_t, F_CODE_ID)[l], PL(int32_t, F_PC)[l]);
  rec[P.L + l] = PL(int32_t, F_STEPS)[l];
}

// after the step: lane l's recorded opcode into the block's bins
MT_DEV void hist_fold(const Planes& P, const int32_t* rec, uint32_t* bins, int l) {
  if (PL(int32_t, F_STEPS)[l] > rec[P.L + l]) MT_ATOMIC_ADD_U32(&bins[rec[l]], 1u);
}
