// sha512.cuh -- the SHA-512 compression for one lane, state and message
// schedule in 64-bit registers.
//
// Replaces the in-kernel SHA-512 of the TPU package: the round logic of
// curve25519_tpu/ops/pallas/sha512_kernel.py (_round, _sigma*, the block
// step of _sha_kernel) and sign_kernel._compress_block. Where the TPU held
// every 64-bit word as a (hi, lo) pair of uint32 tiles, a lane here holds
// native uint64_t words. The 80 rounds run as 5 rolled groups of 16
// unrolled rounds, so the 16-word schedule window keeps static indices and
// stays in registers; K is read by the round counter, which is public.
//
// Messages enter as FIPS 180-4 padded big-endian words in the TPU layout:
// one row of 32 int32 half-words (hi, lo) per 128-byte block.

#pragma once

#include <stdint.h>

#include "fe25519.cuh"

namespace sha512 {

#define SHA512_K_VALUES                                                     \
  0x428A2F98D728AE22ULL, 0x7137449123EF65CDULL, 0xB5C0FBCFEC4D3B2FULL,      \
  0xE9B5DBA58189DBBCULL, 0x3956C25BF348B538ULL, 0x59F111F1B605D019ULL,      \
  0x923F82A4AF194F9BULL, 0xAB1C5ED5DA6D8118ULL, 0xD807AA98A3030242ULL,      \
  0x12835B0145706FBEULL, 0x243185BE4EE4B28CULL, 0x550C7DC3D5FFB4E2ULL,      \
  0x72BE5D74F27B896FULL, 0x80DEB1FE3B1696B1ULL, 0x9BDC06A725C71235ULL,      \
  0xC19BF174CF692694ULL, 0xE49B69C19EF14AD2ULL, 0xEFBE4786384F25E3ULL,      \
  0x0FC19DC68B8CD5B5ULL, 0x240CA1CC77AC9C65ULL, 0x2DE92C6F592B0275ULL,      \
  0x4A7484AA6EA6E483ULL, 0x5CB0A9DCBD41FBD4ULL, 0x76F988DA831153B5ULL,      \
  0x983E5152EE66DFABULL, 0xA831C66D2DB43210ULL, 0xB00327C898FB213FULL,      \
  0xBF597FC7BEEF0EE4ULL, 0xC6E00BF33DA88FC2ULL, 0xD5A79147930AA725ULL,      \
  0x06CA6351E003826FULL, 0x142929670A0E6E70ULL, 0x27B70A8546D22FFCULL,      \
  0x2E1B21385C26C926ULL, 0x4D2C6DFC5AC42AEDULL, 0x53380D139D95B3DFULL,      \
  0x650A73548BAF63DEULL, 0x766A0ABB3C77B2A8ULL, 0x81C2C92E47EDAEE6ULL,      \
  0x92722C851482353BULL, 0xA2BFE8A14CF10364ULL, 0xA81A664BBC423001ULL,      \
  0xC24B8B70D0F89791ULL, 0xC76C51A30654BE30ULL, 0xD192E819D6EF5218ULL,      \
  0xD69906245565A910ULL, 0xF40E35855771202AULL, 0x106AA07032BBD1B8ULL,      \
  0x19A4C116B8D2D0C8ULL, 0x1E376C085141AB53ULL, 0x2748774CDF8EEB99ULL,      \
  0x34B0BCB5E19B48A8ULL, 0x391C0CB3C5C95A63ULL, 0x4ED8AA4AE3418ACBULL,      \
  0x5B9CCA4F7763E373ULL, 0x682E6FF3D6B2B8A3ULL, 0x748F82EE5DEFB2FCULL,      \
  0x78A5636F43172F60ULL, 0x84C87814A1F0AB72ULL, 0x8CC702081A6439ECULL,      \
  0x90BEFFFA23631E28ULL, 0xA4506CEBDE82BDE9ULL, 0xBEF9A3F7B2C67915ULL,      \
  0xC67178F2E372532BULL, 0xCA273ECEEA26619CULL, 0xD186B8C721C0C207ULL,      \
  0xEADA7DD6CDE0EB1EULL, 0xF57D4F7FEE6ED178ULL, 0x06F067AA72176FBAULL,      \
  0x0A637DC5A2C898A6ULL, 0x113F9804BEF90DAEULL, 0x1B710B35131C471BULL,      \
  0x28DB77F523047D84ULL, 0x32CAAB7B40C72493ULL, 0x3C9EBE0A15C9BEBCULL,      \
  0x431D67C49C100D4CULL, 0x4CC5D4BECB3E42B6ULL, 0x597F299CFC657E2AULL,      \
  0x5FCB6FAB3AD6FAECULL, 0x6C44198C4A475817ULL

#ifdef __CUDACC__
__constant__ uint64_t kRoundK[80] = {SHA512_K_VALUES};
#endif
static const uint64_t kRoundKHost[80] = {SHA512_K_VALUES};

FE_HD uint64_t round_k(int t) {
#ifdef __CUDA_ARCH__
  return kRoundK[t];
#else
  return kRoundKHost[t];
#endif
}

// Initial hash value H0 (FIPS 180-4 5.3.5).
FE_HD void init(uint64_t (&st)[8]) {
  st[0] = 0x6A09E667F3BCC908ULL;
  st[1] = 0xBB67AE8584CAA73BULL;
  st[2] = 0x3C6EF372FE94F82BULL;
  st[3] = 0xA54FF53A5F1D36F1ULL;
  st[4] = 0x510E527FADE682D1ULL;
  st[5] = 0x9B05688C2B3E6C1FULL;
  st[6] = 0x1F83D9ABFB41BD6BULL;
  st[7] = 0x5BE0CD19137E2179ULL;
}

// x >> n and the rotate right by n (0 < n < 64; n is a constant where the
// rounds are unrolled). On the card both act on the 32-bit halves by funnel
// shifts, a rotate by 32 + k swapping the halves first.
FE_HD uint64_t shr(uint64_t x, int n) {
#ifdef __CUDA_ARCH__
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  return ((uint64_t)(hi >> n) << 32) | __funnelshift_r(lo, hi, n);
#else
  return x >> n;
#endif
}

FE_HD uint64_t rotr(uint64_t x, int n) {
#ifdef __CUDA_ARCH__
  uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  if (n >= 32) {
    const uint32_t t = lo;
    lo = hi;
    hi = t;
    n -= 32;
  }
  return ((uint64_t)__funnelshift_r(hi, lo, n) << 32) | __funnelshift_r(lo, hi, n);
#else
  return (x >> n) | (x << (64 - n));
#endif
}

// st += compression of the 16-word block w (w is consumed as the rolling
// message schedule).
FE_HD void compress(uint64_t (&st)[8], uint64_t (&w)[16]) {
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll 1
  for (int r = 0; r < 80; r += 16) {
#pragma unroll
    for (int j = 0; j < 16; j++) {
      if (r > 0) {
        const uint64_t w2 = w[(j + 14) & 15], w15 = w[(j + 1) & 15];
        w[j] += (rotr(w2, 19) ^ rotr(w2, 61) ^ shr(w2, 6)) + w[(j + 9) & 15] +
                (rotr(w15, 1) ^ rotr(w15, 8) ^ shr(w15, 7));
      }
      const uint64_t t1 = h + (rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41)) +
                          ((e & f) ^ (~e & g)) + round_k(r + j) + w[j];
      const uint64_t t2 = (rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39)) +
                          ((a & b) ^ (a & c) ^ (b & c));
      h = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = b;
      b = a;
      a = t1 + t2;
    }
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// Block `blk` of a lane's padded word row: 32 int32 half-words (hi, lo).
FE_HD void load_block(uint64_t (&w)[16], const int32_t* row, int64_t blk) {
  const int32_t* p = row + 32 * blk;
#pragma unroll
  for (int t = 0; t < 16; t++)
    w[t] = ((uint64_t)(uint32_t)p[2 * t] << 32) | (uint32_t)p[2 * t + 1];
}

// Big-endian 64-bit word from 8 bytes.
FE_HD uint64_t be_word(const uint8_t* b) {
  uint64_t v = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) v = (v << 8) | b[k];
  return v;
}

// Digest bytes in stream order: byte 8i + k is bits [56-8k, 64-8k) of st[i].
FE_HD void digest_bytes(int32_t (&out)[64], const uint64_t (&st)[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
#pragma unroll
    for (int k = 0; k < 8; k++) out[8 * i + k] = (int32_t)((st[i] >> (56 - 8 * k)) & 0xFF);
  }
}

}  // namespace sha512
