// K6/K7's per-segment logic: the plane (un)packing of
// mythril_tpu/laser/tpu/transfer.py (split_segments/_split_batch :171,
// :236 on the way up; _flatten_device :410 on the way down). Pure data
// movement; every segment is one plane, seen as ``rows`` rows of bytes.
//
// Unpack (K6), one table row of 6 int64 per plane:
//   [src_off, dst_ptr, rows, ship_row_bytes, full_row_bytes, flags]
//   dst row r = src bytes [src_off + r*ship, +ship) then zeros up to
//   full; src_off < 0 means the plane was not shipped (all zeros);
//   flags & 1 normalises bytes to 0/1 (bool planes, ``!= 0``).
// Pack (K7), one table row per plane:
//   [src_ptr, dst_off, rows, ship_row_bytes, src_row_bytes, 0]
//   dst bytes [dst_off + r*ship, +ship) = src row r's first ship bytes.
// Element i of a segment is handled by the thread with i in its stride;
// 4-byte units are used where every offset and row size allows.
#pragma once
#include "common.cuh"

#define SEG_COLS 6

MT_DEV void unpack_segment(const uint8_t* buf, const int64_t* seg, int64_t i0, int64_t stride) {
  int64_t src_off = seg[0];
  uint8_t* dst = (uint8_t*)(uintptr_t)seg[1];
  int64_t rows = seg[2], ship = seg[3], full = seg[4];
  bool is_bool = seg[5] & 1;
  if (!is_bool && ship % 4 == 0 && full % 4 == 0 && (src_off < 0 || src_off % 4 == 0) &&
      ((uintptr_t)dst & 3) == 0) {
    int64_t s4 = ship / 4, f4 = full / 4, n = rows * f4;
    const uint32_t* src = (const uint32_t*)(buf + (src_off < 0 ? 0 : src_off));
    uint32_t* d = (uint32_t*)dst;
    for (int64_t i = i0; i < n; i += stride) {
      int64_t r = i / f4, c = i - r * f4;
      d[i] = (src_off >= 0 && c < s4) ? src[r * s4 + c] : 0u;
    }
    return;
  }
  int64_t n = rows * full;
  for (int64_t i = i0; i < n; i += stride) {
    int64_t r = i / full, c = i - r * full;
    uint8_t v = (src_off >= 0 && c < ship) ? buf[src_off + r * ship + c] : 0;
    dst[i] = is_bool ? (uint8_t)(v != 0) : v;
  }
}

MT_DEV void pack_segment(uint8_t* out, const int64_t* seg, int64_t i0, int64_t stride) {
  const uint8_t* src = (const uint8_t*)(uintptr_t)seg[0];
  int64_t dst_off = seg[1], rows = seg[2], ship = seg[3], srow = seg[4];
  if (ship % 4 == 0 && srow % 4 == 0 && dst_off % 4 == 0 && ((uintptr_t)src & 3) == 0) {
    int64_t s4 = ship / 4, r4 = srow / 4, n = rows * s4;
    const uint32_t* s = (const uint32_t*)src;
    uint32_t* d = (uint32_t*)(out + dst_off);
    for (int64_t i = i0; i < n; i += stride) {
      int64_t r = i / s4, c = i - r * s4;
      d[i] = s[r * r4 + c];
    }
    return;
  }
  int64_t n = rows * ship;
  for (int64_t i = i0; i < n; i += stride) {
    int64_t r = i / ship, c = i - r * ship;
    out[dst_off + i] = src[r * srow + c];
  }
}
