// 256-bit EVM word arithmetic for the step kernel (replaces
// mythril_tpu/laser/tpu/words.py, inlined into K1).
//
// At the plane boundary a word is 16 LSB-first 16-bit digits in u32
// slots, as in the reference. Inside, the expensive operations (products,
// long division, EXP) run on 8 LSB-first 32-bit limbs with 64-bit
// intermediates; digits and limbs convert losslessly. Semantics are EVM:
// DIV/MOD by zero give 0, SDIV -2^255 / -1 wraps, EXP is mod 2^256,
// shifts >= 256 give 0 (or the sign fill for SAR).
#pragma once
#include "common.cuh"

#define ND 16

MT_DEV void w_zero(uint32_t* r) { for (int i = 0; i < ND; ++i) r[i] = 0; }
MT_DEV void w_copy(uint32_t* r, const uint32_t* a) { for (int i = 0; i < ND; ++i) r[i] = a[i]; }

MT_DEV void to_limbs(uint32_t* l, const uint32_t* d, int nlimbs) {
  for (int i = 0; i < nlimbs; ++i) l[i] = (d[2 * i] & 0xFFFFu) | (d[2 * i + 1] << 16);
}
MT_DEV void from_limbs(uint32_t* d, const uint32_t* l, int nlimbs) {
  for (int i = 0; i < nlimbs; ++i) { d[2 * i] = l[i] & 0xFFFFu; d[2 * i + 1] = l[i] >> 16; }
}

MT_DEV uint32_t w_to_u32(const uint32_t* w) { return w[0] | (w[1] << 16); }
MT_DEV bool w_fits_u32(const uint32_t* w) {
  for (int i = 2; i < ND; ++i) if (w[i]) return false;
  return true;
}
MT_DEV void w_from_u32(uint32_t* r, uint32_t x) { w_zero(r); r[0] = x & 0xFFFFu; r[1] = x >> 16; }
MT_DEV bool w_is_zero(const uint32_t* a) {
  for (int i = 0; i < ND; ++i) if (a[i]) return false;
  return true;
}
MT_DEV bool w_eq(const uint32_t* a, const uint32_t* b) {
  for (int i = 0; i < ND; ++i) if (a[i] != b[i]) return false;
  return true;
}

// r = a + b mod 2^256; returns the carry out (0/1). r may alias a or b.
MT_DEV uint32_t w_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t carry = 0;
  for (int i = 0; i < ND; ++i) { uint32_t t = a[i] + b[i] + carry; r[i] = t & 0xFFFFu; carry = t >> 16; }
  return carry;
}
// r = a - b mod 2^256; returns true where a < b.
MT_DEV bool w_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t carry = 1;
  for (int i = 0; i < ND; ++i) {
    uint32_t t = a[i] + (0xFFFFu - b[i]) + carry; r[i] = t & 0xFFFFu; carry = t >> 16;
  }
  return carry == 0;
}
MT_DEV bool w_ult(const uint32_t* a, const uint32_t* b) {
  for (int i = ND - 1; i >= 0; --i) if (a[i] != b[i]) return a[i] < b[i];
  return false;
}
MT_DEV bool w_slt(const uint32_t* a, const uint32_t* b) {
  uint32_t sa = a[ND - 1] >> 15, sb = b[ND - 1] >> 15;
  if (sa != sb) return sa > sb;
  return w_ult(a, b);
}
MT_DEV uint32_t w_sign(const uint32_t* a) { return (a[ND - 1] >> 15) & 1u; }
MT_DEV void w_neg(uint32_t* r, const uint32_t* a) {
  uint32_t z[ND]; w_zero(z); w_sub(r, z, a);
}
MT_DEV void w_bool(uint32_t* r, bool m) { w_zero(r); r[0] = m ? 1u : 0u; }

// 8x8 limb schoolbook product, full 512 bits (16 limbs).
MT_DEV void l_mul_full(uint32_t* r16, const uint32_t* a8, const uint32_t* b8) {
  for (int i = 0; i < 16; ++i) r16[i] = 0;
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
    for (int j = 0; j < 8; ++j) {
      uint64_t t = (uint64_t)a8[i] * b8[j] + r16[i + j] + carry;
      r16[i + j] = (uint32_t)t; carry = t >> 32;
    }
    r16[i + 8] = (uint32_t)carry;
  }
}
// low 256 bits of a*b
MT_DEV void l_mul_lo(uint32_t* r8, const uint32_t* a8, const uint32_t* b8) {
  uint32_t t8[8];
  for (int i = 0; i < 8; ++i) t8[i] = 0;
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
    for (int j = 0; i + j < 8; ++j) {
      uint64_t t = (uint64_t)a8[i] * b8[j] + t8[i + j] + carry;
      t8[i + j] = (uint32_t)t; carry = t >> 32;
    }
  }
  for (int i = 0; i < 8; ++i) r8[i] = t8[i];
}

MT_DEV void w_mul_full(uint32_t* r32, const uint32_t* a, const uint32_t* b) {
  uint32_t a8[8], b8[8], r16[16];
  to_limbs(a8, a, 8); to_limbs(b8, b, 8);
  l_mul_full(r16, a8, b8);
  from_limbs(r32, r16, 16);
}
MT_DEV void w_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t a8[8], b8[8], r8[8];
  to_limbs(a8, a, 8); to_limbs(b8, b, 8);
  l_mul_lo(r8, a8, b8);
  from_limbs(r, r8, 8);
}

// Shift-subtract long division of the low `nbits` bits of dividend
// (nlimbs 32-bit limbs) by a 256-bit divisor (8 limbs). Writes the
// remainder (8 limbs) and, when quot8 is given, the low 256 quotient bits.
// Same recurrence as the reference's _divmod_wide; the caller handles /0.
MT_DEV void l_divmod(const uint32_t* dividend, int nbits, const uint32_t* d8,
                     uint32_t* quot8, uint32_t* rem8) {
  uint32_t rem[8];
  for (int i = 0; i < 8; ++i) { rem[i] = 0; if (quot8) quot8[i] = 0; }
  for (int i = nbits - 1; i >= 0; --i) {
    uint32_t bit = (dividend[i >> 5] >> (i & 31)) & 1u;
    bool overflow = (rem[7] >> 31) != 0;
    for (int k = 7; k > 0; --k) rem[k] = (rem[k] << 1) | (rem[k - 1] >> 31);
    rem[0] = (rem[0] << 1) | bit;
    bool ge = overflow;
    if (!ge) {
      ge = true;  // rem >= divisor?
      for (int k = 7; k >= 0; --k) {
        if (rem[k] != d8[k]) { ge = rem[k] > d8[k]; break; }
      }
    }
    if (ge) {
      uint64_t borrow = 0;
      for (int k = 0; k < 8; ++k) {
        uint64_t t = (uint64_t)rem[k] - d8[k] - borrow;
        rem[k] = (uint32_t)t; borrow = (t >> 63) & 1u;
      }
      if (quot8 && i < 256) quot8[i >> 5] |= 1u << (i & 31);
    }
  }
  for (int i = 0; i < 8; ++i) rem8[i] = rem[i];
}

// EVM DIV/MOD: both 0 when b == 0
MT_DEV void w_divmod(uint32_t* q, uint32_t* r, const uint32_t* a, const uint32_t* b) {
  if (w_is_zero(b)) { w_zero(q); w_zero(r); return; }
  uint32_t a8[8], b8[8], q8[8], r8[8];
  to_limbs(a8, a, 8); to_limbs(b8, b, 8);
  l_divmod(a8, 256, b8, q8, r8);
  from_limbs(q, q8, 8); from_limbs(r, r8, 8);
}
MT_DEV void w_abs(uint32_t* r, const uint32_t* a) {
  if (w_sign(a)) w_neg(r, a); else w_copy(r, a);
}
// ADDMOD (257-bit intermediate) / MULMOD (512-bit); 0 when n == 0
MT_DEV void w_addmod(uint32_t* r, const uint32_t* a, const uint32_t* b, const uint32_t* n) {
  if (w_is_zero(n)) { w_zero(r); return; }
  uint32_t s[ND]; uint32_t carry = w_add(s, a, b);
  uint32_t wide[16], n8[8], r8[8];
  to_limbs(wide, s, 8);
  wide[8] = carry;
  for (int i = 9; i < 16; ++i) wide[i] = 0;
  to_limbs(n8, n, 8);
  l_divmod(wide, 512, n8, 0, r8);
  from_limbs(r, r8, 8);
}
MT_DEV void w_mulmod(uint32_t* r, const uint32_t* a, const uint32_t* b, const uint32_t* n) {
  if (w_is_zero(n)) { w_zero(r); return; }
  uint32_t a8[8], b8[8], wide[16], n8[8], r8[8];
  to_limbs(a8, a, 8); to_limbs(b8, b, 8); to_limbs(n8, n, 8);
  l_mul_full(wide, a8, b8);
  l_divmod(wide, 512, n8, 0, r8);
  from_limbs(r, r8, 8);
}
MT_DEV void w_exp(uint32_t* r, const uint32_t* a, const uint32_t* e) {
  uint32_t res8[8], base8[8], e8[8];
  to_limbs(base8, a, 8); to_limbs(e8, e, 8);
  for (int i = 0; i < 8; ++i) res8[i] = 0;
  res8[0] = 1;
  for (int i = 0; i < 256; ++i) {
    if ((e8[i >> 5] >> (i & 31)) & 1u) l_mul_lo(res8, res8, base8);
    l_mul_lo(base8, base8, base8);
  }
  from_limbs(r, res8, 8);
}

// shift amount >= 256 (or not fitting u32) -> over
MT_DEV bool w_shift_amount(const uint32_t* s, uint32_t* amt) {
  uint32_t u = w_to_u32(s);
  *amt = u & 0xFFu;
  return !w_fits_u32(s) || u >= 256u;
}
MT_DEV void w_shl(uint32_t* r, const uint32_t* s, const uint32_t* a) {
  uint32_t amt; bool over = w_shift_amount(s, &amt);
  int d = amt / 16, b = amt % 16;
  uint32_t t[ND];
  for (int k = 0; k < ND; ++k) {
    int i1 = k - d, i2 = i1 - 1;
    uint32_t a1 = i1 >= 0 ? a[i1] : 0u, a2 = i2 >= 0 ? a[i2] : 0u;
    t[k] = ((a1 << b) | (a2 >> (16 - b))) & 0xFFFFu;
  }
  for (int k = 0; k < ND; ++k) r[k] = over ? 0u : t[k];
}
MT_DEV void w_shr(uint32_t* r, const uint32_t* s, const uint32_t* a) {
  uint32_t amt; bool over = w_shift_amount(s, &amt);
  int d = amt / 16, b = amt % 16;
  uint32_t t[ND];
  for (int k = 0; k < ND; ++k) {
    int i1 = k + d, i2 = i1 + 1;
    uint32_t a1 = i1 < ND ? a[i1] : 0u, a2 = i2 < ND ? a[i2] : 0u;
    t[k] = ((a1 >> b) | (a2 << (16 - b))) & 0xFFFFu;
  }
  for (int k = 0; k < ND; ++k) r[k] = over ? 0u : t[k];
}
MT_DEV void w_sar(uint32_t* r, const uint32_t* s, const uint32_t* a) {
  uint32_t fill = w_sign(a) ? 0xFFFFu : 0u;
  uint32_t amt; bool over = w_shift_amount(s, &amt);
  int d = amt / 16, b = amt % 16;
  uint32_t t[ND];
  for (int k = 0; k < ND; ++k) {
    int i1 = k + d, i2 = i1 + 1;
    uint32_t a1 = i1 < ND ? a[i1] : fill, a2 = i2 < ND ? a[i2] : fill;
    t[k] = ((a1 >> b) | (a2 << (16 - b))) & 0xFFFFu;
  }
  for (int k = 0; k < ND; ++k) r[k] = over ? fill : t[k];
}
MT_DEV void w_byte(uint32_t* r, const uint32_t* i, const uint32_t* w) {
  uint32_t iv = w_to_u32(i);
  bool valid = w_fits_u32(i) && iv < 32u;
  uint32_t byte = 0;
  if (valid) {
    uint32_t pos = (31u - iv) * 8u;
    byte = (w[pos / 16] >> (pos % 16)) & 0xFFu;
  }
  w_zero(r); r[0] = byte;
}
MT_DEV void w_signextend(uint32_t* r, const uint32_t* b, const uint32_t* x) {
  uint32_t bv = w_to_u32(b);
  bool valid = w_fits_u32(b) && bv < 31u;
  if (!valid) { w_copy(r, x); return; }
  uint32_t sign_pos = bv * 8u + 7u;
  uint32_t sbit = (x[sign_pos / 16] >> (sign_pos % 16)) & 1u;
  for (int k = 0; k < ND; ++k) {
    int live = (int)sign_pos + 1 - 16 * k;
    live = live < 0 ? 0 : (live > 16 ? 16 : live);
    uint32_t mask = live >= 16 ? 0xFFFFu : ((1u << live) - 1u);
    r[k] = sbit ? ((x[k] & mask) | (0xFFFFu & ~mask)) : (x[k] & mask);
  }
}
// 32 big-endian bytes -> word
MT_DEV void w_from_bytes_be(uint32_t* r, const uint8_t* b) {
  for (int i = 0; i < ND; ++i) r[i] = (uint32_t)b[31 - 2 * i] | ((uint32_t)b[30 - 2 * i] << 8);
}
// word -> byte at big-endian position j (0 = most significant)
MT_DEV uint8_t w_byte_be(const uint32_t* w, int j) {
  int p = 31 - j;  // little-endian byte index
  return (uint8_t)((w[p / 2] >> (8 * (p % 2))) & 0xFFu);
}
