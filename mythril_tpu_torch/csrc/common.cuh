// Shared definitions for the port's kernels: the StateBatch plane table,
// the CodeBank pointers, and the loop control word.
//
// Every device function here and in the other headers is plain C++ over
// explicit pointers, so the same source also compiles as host C++ when
// MT_HOST_EMU is defined (a per-lane loop stands in for the grid). The
// CUDA entry points live in the *.cu files.
#pragma once
#include <stdint.h>

#ifdef MT_HOST_EMU
#define MT_DEV static inline
#define MT_DEVM inline
#define MT_HD static inline
#else
#define MT_DEV __device__ __forceinline__
#define MT_DEVM __device__ __forceinline__
#define MT_HD __host__ __device__ __forceinline__
#endif

// StateBatch fields, in StateBatch._fields order (batch.py). The Python
// side passes one pointer and one row size (bytes per lane) per field.
enum Field {
  F_ALIVE, F_STATUS, F_TRAP_OP, F_PC, F_CODE_ID, F_STACK, F_SP, F_MEMORY,
  F_MEM_WORDS, F_GAS_LEFT, F_GAS_SPENT_MAX, F_STORAGE_KEY, F_STORAGE_VAL,
  F_STORAGE_USED, F_RET_OFF, F_RET_LEN, F_CALLDATA, F_CALLDATA_LEN,
  F_CALLVALUE, F_CALLER, F_ORIGIN, F_ADDRESS, F_BALANCE, F_STEPS, F_VISITED,
  F_JD_RING, F_JD_CNT, F_JUMP_CNT, F_SS_PC, F_SS_KEY, F_SS_VAL, F_SS_IS_LOAD,
  F_SS_JD, F_SS_CNT, F_SPILL_ID, F_STACK_SYM, F_TAPE_OP, F_TAPE_A, F_TAPE_B,
  F_TAPE_IMM, F_TAPE_H1, F_TAPE_H2, F_TAPE_META, F_TAPE_LEN, F_PATH_ID,
  F_PATH_SIGN, F_PATH_META, F_PATH_LEN, F_MSYM_OFF, F_MSYM_ID, F_MSYM_USED,
  F_SKEY_SYM, F_SVAL_SYM, F_CALLDATA_SYMBOLIC, F_STORAGE_SYMBOLIC,
  F_CDSIZE_SYM, F_CALLER_SYM, F_CALLVALUE_SYM, F_ORIGIN_SYM, F_BALANCE_SYM,
  F_SEED_ID, F_JOB_ID, F_OUTERMOST, F_STATIC_PRUNED, NFIELDS
};

struct Planes {
  void* p[NFIELDS];
  int64_t row_bytes[NFIELDS];
  int L, S, M, C, K, CL, T, P, MS, SSR, JD, n_codes;
};

struct Bank {
  const uint8_t* code;        // [n, CL]
  const int32_t* code_len;    // [n]
  const uint8_t* jumpdest;    // [n, CL]
  const uint32_t* push_imm;   // [n, CL, 16]
  const uint8_t* host_ops;    // [256]
  const uint8_t* freeze_errors;
  const uint8_t* record_storage_events;
  const uint8_t* must_revert; // [n, CL]
  const uint8_t* prune_revert;
  const int8_t* jumpi_verdict; // [n, CL]
};

// opcode tables (engine.py), one row of 256 each, passed as int32[9*256]
enum Table { TB_POPS, TB_PUSHES, TB_GAS, TB_GAS_MAX, TB_INVALID, TB_TRAP,
             TB_SYM_OP, TB_SYM_ARITY, TB_ENV_LEAF, NTABLES };

#define PL(T_, f) ((T_*)P.p[f])

enum Status { RUNNING = 0, STOPPED = 1, RETURNED = 2, REVERTED = 3, ERROR_ = 4,
              TRAP = 5, TRAP_SS = 6 };

#ifdef MT_HOST_EMU
struct alignas(16) mt_u4 { uint32_t x, y, z, w; };
#else
typedef uint4 mt_u4;
#endif

// Copy one lane's row of every plane (fork children, compaction), 16
// bytes a load where the row size and both planes allow it.
MT_DEV void copy_row_part(const Planes& src, const Planes& dst, int s_lane,
                          int d_lane, int tid, int nthreads) {
  for (int f = 0; f < NFIELDS; ++f) {
    int64_t rb = src.row_bytes[f];
    if ((rb & 15) == 0 && (((uintptr_t)src.p[f] | (uintptr_t)dst.p[f]) & 15) == 0) {
      const mt_u4* s = (const mt_u4*)((const uint8_t*)src.p[f] + rb * s_lane);
      mt_u4* d = (mt_u4*)((uint8_t*)dst.p[f] + rb * d_lane);
      for (int64_t i = tid; i < rb / 16; i += nthreads) d[i] = s[i];
    } else if ((rb & 3) == 0) {
      const uint32_t* s = (const uint32_t*)((const uint8_t*)src.p[f] + rb * s_lane);
      uint32_t* d = (uint32_t*)((uint8_t*)dst.p[f] + rb * d_lane);
      for (int64_t i = tid; i < rb / 4; i += nthreads) d[i] = s[i];
    } else {
      const uint8_t* s = (const uint8_t*)src.p[f] + rb * s_lane;
      uint8_t* d = (uint8_t*)dst.p[f] + rb * d_lane;
      for (int64_t i = tid; i < rb; i += nthreads) d[i] = s[i];
    }
  }
}

#ifndef MT_HOST_EMU
#include <cuda_runtime.h>
#define MT_EXPORT extern "C" __attribute__((visibility("default")))
#define MT_ERROR_STRING_FN                                   \
  MT_EXPORT const char* mt_error_string(int code) {          \
    return cudaGetErrorString((cudaError_t)code);            \
  }
#endif
