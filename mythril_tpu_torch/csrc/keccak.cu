// K2: batched Keccak-256 (replaces mythril_tpu/laser/tpu/keccak_tpu.py:126
// keccak256_batch). One thread per row; the state lives in registers.
// A row is a window of a byte plane: byte i of row r is
// base[r * stride + off[r] + i] for i < avail[r], else 0 (off/avail null:
// 0 and n). Rows with active[r] == 0 are skipped (active null: all run).
// The step kernel (K1) hashes its lanes' SHA3 windows itself.
// Bound: bytes (each row's message bytes read once, 32 written).
#include "keccak.cuh"

__global__ void keccak256_rows(const uint8_t* base, int64_t stride, const int32_t* off,
                               const int32_t* avail, const int32_t* length, const uint8_t* active,
                               uint8_t* out, int rows, int n, int max_blocks, const int32_t* ctl) {
  if (ctl && !ctl[1]) return;
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  if (active && !active[r]) return;
  WindowGet g{base + (int64_t)r * stride + (off ? off[r] : 0), avail ? avail[r] : n};
  keccak256_padded(g, length[r], max_blocks, out + (int64_t)r * 32);
}

MT_ERROR_STRING_FN

MT_EXPORT int mt_keccak256_rows(const uint8_t* base, int64_t stride, const int32_t* off,
                                const int32_t* avail, const int32_t* length,
                                const uint8_t* active, uint8_t* out, int rows, int n,
                                int max_blocks, const int32_t* ctl, cudaStream_t stream) {
  if (rows <= 0) return 0;
  int threads = 128;
  keccak256_rows<<<(rows + threads - 1) / threads, threads, 0, stream>>>(
      base, stride, off, avail, length, active, out, rows, n, max_blocks, ctl);
  return (int)cudaGetLastError();
}
