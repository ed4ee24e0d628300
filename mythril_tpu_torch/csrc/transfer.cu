// K6 unpack and K7 pack: the single-buffer StateBatch transport
// (replaces mythril_tpu/laser/tpu/transfer.py:171 _split_jit, :236
// _split_batch and :410 _flatten_device). One launch per direction moves
// every plane: blockIdx.y picks the segment (one plane), the blocks of a
// row stride over its bytes. Bound: device-memory bytes read and written.
#include "transfer.cuh"

#define XFER_THREADS 256

__global__ void unpack_kernel(const uint8_t* buf, const int64_t* table) {
  const int64_t* seg = table + (int64_t)blockIdx.y * SEG_COLS;
  unpack_segment(buf, seg, (int64_t)blockIdx.x * blockDim.x + threadIdx.x,
                 (int64_t)gridDim.x * blockDim.x);
}

__global__ void pack_kernel(uint8_t* out, const int64_t* table) {
  const int64_t* seg = table + (int64_t)blockIdx.y * SEG_COLS;
  pack_segment(out, seg, (int64_t)blockIdx.x * blockDim.x + threadIdx.x,
               (int64_t)gridDim.x * blockDim.x);
}

static int grid_x(int64_t max_units) {
  int64_t b = (max_units + XFER_THREADS - 1) / XFER_THREADS;
  if (b > 256) b = 256;
  return b < 1 ? 1 : (int)b;
}

MT_ERROR_STRING_FN

// table lives in device memory (nseg rows of SEG_COLS int64);
// max_bytes = the largest segment's byte count (sizes the grid)
MT_EXPORT int mt_unpack(const uint8_t* buf, const int64_t* table, int nseg, int64_t max_bytes,
                        cudaStream_t stream) {
  if (nseg <= 0 || nseg > 65535) return (int)cudaErrorInvalidValue;
  unpack_kernel<<<dim3(grid_x(max_bytes / 4 + 1), nseg), XFER_THREADS, 0, stream>>>(buf, table);
  return (int)cudaGetLastError();
}

MT_EXPORT int mt_pack(uint8_t* out, const int64_t* table, int nseg, int64_t max_bytes,
                      cudaStream_t stream) {
  if (nseg <= 0 || nseg > 65535) return (int)cudaErrorInvalidValue;
  pack_kernel<<<dim3(grid_x(max_bytes / 4 + 1), nseg), XFER_THREADS, 0, stream>>>(out, table);
  return (int)cudaGetLastError();
}
