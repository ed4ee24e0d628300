// K6/K7's logic: the plane (un)packing of mythril_tpu/laser/tpu/transfer.py
// (split_segments/_split_jit :171 and _split_batch :236 on the way up;
// _flatten_device :410 on the way down). Pure data movement, so the bound
// on the H100 is device-memory bytes (each byte read once and written
// once) at 3.35 TB/s; a copy needs neither TMA nor wgmma, only 16-byte
// loads and stores with enough of them in flight.
//
// Both directions are one table of segments, one copy each: ``rows`` rows
// of ``w_out`` bytes at ``dst``, row r's first ``w_copy`` bytes read from
// ``src + r * w_in`` and the rest zero (``src`` 0: all zero). K6 has one
// segment per plane (w_out = full row, w_in = w_copy = shipped prefix, or
// zeros for an absent plane; XF_BOOL writes bytes as != 0); K7 one per
// plane and lane block (w_out = w_copy = shipped prefix, w_in = the
// plane's row). The wrapper folds a segment whose rows are back to back
// (K6 unsliced or absent, K7 unsliced) into one row: a single run of
// bytes. Only the tape planes sliced to the used columns keep rows.
//
// The work is the segments' units, numbered across the table (``first``
// is each segment's exclusive prefix; the wrapper drops empty segments):
// - ``upr`` > 0: a 16-byte unit of a row (``upr`` units a row), when the
//   destination, the source and, for several rows, the three widths are
//   16-byte aligned (a single row copies all of it or none); the row
//   comes from one 32-bit division (none for a single row). A unit inside
//   the copied prefix is one uint4 load and store, one past it a uint4
//   store of zeros (no load); a single row's last unit, when shorter than
//   16 bytes, is done byte by byte.
// - ``upr`` == 0 (misaligned; the tests' small configurations and odd
//   uploads): 16 bytes of the flat output a unit, byte by byte.
// A block stages the table in shared memory once and finds a unit's
// segment by binary search over ``first``. Thread t of a chunk of
// XFER_UNROLL x threads units takes units t, t + threads, ..., loading
// all of its 16-byte units before it stores any.
#pragma once
#include "common.cuh"

#define XFER_UNROLL 4       // units a thread loads before it stores any
#define XFER_MAX_SEGS 672   // the largest table a launch takes by value (32 KB of parameters)
#define XF_BOOL 1           // flags: write each byte as (byte != 0)

struct XferSeg {
  uint64_t src;  // 0: the segment is all zeros
  uint64_t dst;
  uint32_t rows, w_out, w_in, w_copy;
  uint32_t upr;  // 16-byte units a row; 0: byte units over the flat output
  uint32_t flags, first, pad;
};
static_assert(sizeof(XferSeg) == 48, "transfer.py XFER_SEG mirrors this layout");

// 0x01 in each byte of w that is not zero, else 0x00
MT_DEV uint32_t xfer_nonzero_bytes(uint32_t w) {
  return ((((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) >> 7) & 0x01010101u;
}

// A block's copy of the table, thread tid of nthreads.
MT_DEV void xfer_stage(const XferSeg* table, int nseg, XferSeg* sm, int tid, int nthreads) {
  const uint32_t* s = (const uint32_t*)table;
  uint32_t* d = (uint32_t*)sm;
  for (int i = tid; i < nseg * (int)(sizeof(XferSeg) / 4); i += nthreads) d[i] = s[i];
}

// The segment that holds unit u: the last one whose first unit is <= u.
MT_DEV int xfer_find(const XferSeg* sm, int nseg, uint32_t u) {
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (sm[mid].first <= u) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

MT_DEV uint8_t xfer_byte(const XferSeg& s, uint32_t r, uint32_t c) {
  const uint8_t v = c < s.w_copy ? ((const uint8_t*)(uintptr_t)s.src)[(uint64_t)r * s.w_in + c] : 0;
  return (s.flags & XF_BOOL) ? (uint8_t)(v != 0) : v;
}

// Bytes [lo, hi) of row r.
MT_DEV void xfer_row_bytes(const XferSeg& s, uint32_t r, uint32_t lo, uint32_t hi) {
  uint8_t* d = (uint8_t*)(uintptr_t)s.dst + (uint64_t)r * s.w_out;
  for (uint32_t c = lo; c < hi; ++c) d[c] = xfer_byte(s, r, c);
}

// Byte unit ul: flat output bytes [16 ul, 16 ul + 16) of the segment.
MT_DEV void xfer_flat_unit(const XferSeg& s, uint32_t ul) {
  const uint32_t n = s.rows * s.w_out, a = ul * 16, b = n - a < 16 ? n : a + 16;
  uint32_t r = a / s.w_out, c = a - r * s.w_out;
  uint8_t* d = (uint8_t*)(uintptr_t)s.dst;
  for (uint32_t i = a; i < b; ++i) {
    d[i] = xfer_byte(s, r, c);
    if (++c == s.w_out) c = 0, ++r;
  }
}

// Units u0, u0 + step, ..., XFER_UNROLL of them (those below total).
MT_DEV void xfer_units(const XferSeg* sm, int nseg, uint32_t total, uint32_t u0, uint32_t step) {
  mt_u4 v[XFER_UNROLL];
  mt_u4* d[XFER_UNROLL];
  uint32_t norm = 0;
#pragma unroll
  for (int k = 0; k < XFER_UNROLL; ++k) {
    d[k] = nullptr;
    const uint32_t u = u0 + k * step;
    if (u >= total) continue;
    const XferSeg& s = sm[xfer_find(sm, nseg, u)];
    const uint32_t ul = u - s.first;
    if (!s.upr) {
      xfer_flat_unit(s, ul);
      continue;
    }
    const uint32_t r = s.rows == 1 ? 0 : ul / s.upr;
    const uint32_t lo = (ul - r * s.upr) * 16;
    if (s.w_out - lo < 16) {
      xfer_row_bytes(s, r, lo, s.w_out);
      continue;
    }
    d[k] = (mt_u4*)((uint8_t*)(uintptr_t)s.dst + (uint64_t)r * s.w_out + lo);
    if (lo < s.w_copy) {
      v[k] = *(const mt_u4*)((const uint8_t*)(uintptr_t)s.src + (uint64_t)r * s.w_in + lo);
    } else {
      v[k].x = v[k].y = v[k].z = v[k].w = 0u;
    }
    if (s.flags & XF_BOOL) norm |= 1u << k;
  }
#pragma unroll
  for (int k = 0; k < XFER_UNROLL; ++k) {
    if (!d[k]) continue;
    mt_u4 w = v[k];
    if (norm >> k & 1u) {
      w.x = xfer_nonzero_bytes(w.x);
      w.y = xfer_nonzero_bytes(w.y);
      w.z = xfer_nonzero_bytes(w.z);
      w.w = xfer_nonzero_bytes(w.w);
    }
    *d[k] = w;
  }
}

// Thread tid of block `block` (of nblocks, nthreads each): its units of
// every chunk the block takes, grid-stride, after the block's staging.
MT_DEV void xfer_thread(const XferSeg* sm, int nseg, uint32_t total, uint32_t block, uint32_t nblocks,
                        uint32_t tid, uint32_t nthreads) {
  const uint32_t chunk = XFER_UNROLL * nthreads;
  for (uint32_t base = block * chunk; base < total; base += nblocks * chunk)
    xfer_units(sm, nseg, total, base + tid, nthreads);
}
