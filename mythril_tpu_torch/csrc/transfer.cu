// K6 unpack and K7 pack: the single-buffer StateBatch transport (replaces
// mythril_tpu/laser/tpu/transfer.py:171 _split_jit, :236 _split_batch and
// :410 _flatten_device). Both are one launch of xfer_kernel over a table
// of segments (transfer.cuh), passed by value as a __grid_constant__
// parameter: no table is copied to the card before a launch. The grid is
// balanced over the total work, not one grid row per plane: at most
// XFER_BLOCKS_PER_SM blocks an SM, each taking chunks of XFER_UNROLL x
// XFER_THREADS units, grid-stride, after staging the table in shared
// memory. Bound: device-memory bytes, each read once and written once,
// at 3.35 TB/s.
#include <string.h>

#include "transfer.cuh"

#define XFER_THREADS 256
#define XFER_BLOCKS_PER_SM 4
#define MAX_DEVICES 64

template <int CAP>
struct XferTable {
  uint32_t nseg, total, pad0, pad1;
  XferSeg seg[CAP];
};

template <int CAP>
__global__ void __launch_bounds__(XFER_THREADS, XFER_BLOCKS_PER_SM)
    xfer_kernel(const __grid_constant__ XferTable<CAP> t) {
  extern __shared__ XferSeg sm[];
  xfer_stage(t.seg, t.nseg, sm, threadIdx.x, blockDim.x);
  __syncthreads();
  xfer_thread(sm, t.nseg, t.total, blockIdx.x, gridDim.x, threadIdx.x, blockDim.x);
}

static int sm_count(int* out) {
  static int cache[MAX_DEVICES];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return (int)e;
  if (dev < MAX_DEVICES && cache[dev]) {
    *out = cache[dev];
    return 0;
  }
  if ((e = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev))) return (int)e;
  if (dev < MAX_DEVICES) cache[dev] = *out;
  return 0;
}

template <int CAP>
static int launch(const XferSeg* segs, int nseg, uint32_t total, cudaStream_t stream) {
  XferTable<CAP> t;
  t.nseg = (uint32_t)nseg;
  t.total = total;
  t.pad0 = t.pad1 = 0;
  memcpy(t.seg, segs, sizeof(XferSeg) * nseg);
  int sms;
  int err = sm_count(&sms);
  if (err) return err;
  const uint32_t chunk = XFER_UNROLL * XFER_THREADS, chunks = (total + chunk - 1) / chunk;
  const uint32_t most = (uint32_t)sms * XFER_BLOCKS_PER_SM;
  xfer_kernel<CAP><<<chunks < most ? chunks : most, XFER_THREADS, sizeof(XferSeg) * nseg, stream>>>(t);
  return (int)cudaGetLastError();
}

MT_ERROR_STRING_FN

// segs: nseg rows in host memory (copied into the launch's parameters);
// total: the units of all of them (the last row's first + units)
MT_EXPORT int mt_xfer(const XferSeg* segs, int nseg, uint32_t total, cudaStream_t stream) {
  if (nseg < 1 || nseg > XFER_MAX_SEGS || total == 0 || total > 0x80000000u) return (int)cudaErrorInvalidValue;
  if (nseg <= 16) return launch<16>(segs, nseg, total, stream);
  if (nseg <= 64) return launch<64>(segs, nseg, total, stream);
  if (nseg <= 128) return launch<128>(segs, nseg, total, stream);
  return launch<XFER_MAX_SEGS>(segs, nseg, total, stream);
}
