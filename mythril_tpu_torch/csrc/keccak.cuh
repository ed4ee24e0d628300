// Keccak-256 device functions (replaces mythril_tpu/laser/tpu/keccak_tpu.py
// keccak_f / keccak256_batch). Shared by K2 and the step kernel's SHA3.
#pragma once
#include "common.cuh"

#define KECCAK_RATE 136

#ifdef MT_HOST_EMU
static const uint64_t KECCAK_RC[24] = {
#else
__device__ __constant__ uint64_t KECCAK_RC[24] = {
#endif
  0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL, 0x8000000080008000ULL,
  0x000000000000808BULL, 0x0000000080000001ULL, 0x8000000080008081ULL, 0x8000000000008009ULL,
  0x000000000000008AULL, 0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
  0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL, 0x8000000000008003ULL,
  0x8000000000008002ULL, 0x8000000000000080ULL, 0x000000000000800AULL, 0x800000008000000AULL,
  0x8000000080008081ULL, 0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

MT_DEV uint64_t k_rotl(uint64_t x, int n) { return n == 0 ? x : ((x << n) | (x >> (64 - n))); }

// keccak-f[1600]; lane index x + 5y
MT_DEV void keccak_f(uint64_t* s) {
  const int rho[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
                       41, 45, 15, 21, 8, 18, 2, 61, 56, 14};
  for (int rnd = 0; rnd < 24; ++rnd) {
    uint64_t c[5], b[25];
    for (int x = 0; x < 5; ++x) c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
    for (int x = 0; x < 5; ++x) {
      uint64_t d = c[(x + 4) % 5] ^ k_rotl(c[(x + 1) % 5], 1);
      for (int y = 0; y < 5; ++y) s[x + 5 * y] ^= d;
    }
    // rho + pi: b[y + 5*((2x+3y)%5)] = rotl(s[x+5y], rho)
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = k_rotl(s[x + 5 * y], rho[x + 5 * y]);
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x)
        s[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    s[0] ^= KECCAK_RC[rnd];
  }
}

// A window of a byte row: byte i is row[i] for i < avail, else 0 (K2's
// rows and the step's SHA3 over a lane's memory).
struct WindowGet {
  const uint8_t* row;
  int avail;
  MT_DEVM uint32_t operator()(int i) const { return i < avail ? row[i] : 0u; }
};

// Keccak-256 with the reference's padding: message byte i (i < cap =
// max_blocks * RATE) is data(i) for i < length, OR 0x01 at i == length,
// OR 0x80 at the last byte of block ceil((length+1)/RATE); only
// min(nblocks, max_blocks) blocks are absorbed. get(i) returns input
// byte i (callers return 0 past their buffer).
template <typename Get>
MT_DEV void keccak256_padded(Get get, int length, int max_blocks, uint8_t* out32) {
  uint64_t s[25];
  for (int i = 0; i < 25; ++i) s[i] = 0;
  // floor division, as the reference's jnp integer division
  int num = length + KECCAK_RATE;
  int nblocks = num >= 0 ? num / KECCAK_RATE : -((-num + KECCAK_RATE - 1) / KECCAK_RATE);
  int last = nblocks * KECCAK_RATE - 1;
  for (int blk = 0; blk < max_blocks && blk < nblocks; ++blk) {
    for (int lane = 0; lane < KECCAK_RATE / 8; ++lane) {
      uint64_t v = 0;
      for (int k = 0; k < 8; ++k) {
        int i = blk * KECCAK_RATE + lane * 8 + k;
        uint32_t byte = i < length ? (uint32_t)get(i) : 0u;
        if (i == length) byte |= 0x01u;
        if (i == last) byte |= 0x80u;
        v |= (uint64_t)(byte & 0xFFu) << (8 * k);
      }
      s[lane] ^= v;
    }
    keccak_f(s);
  }
  for (int i = 0; i < 32; ++i) out32[i] = (uint8_t)(s[i / 8] >> (8 * (i % 8)));
}
