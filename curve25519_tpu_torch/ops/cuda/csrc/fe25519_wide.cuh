// fe25519_wide.cuh -- field arithmetic mod p = 2^255 - 19 for one lane on
// 32x32->64 products (`IMAD.WIDE.U32` on sm_90a), limbs in registers.
//
// The field core of the ladder (csrc/ladder.cu) and of Verify_Init
// (csrc/verify.cu, through edwards25519_wide.cuh). fe25519.cuh keeps the
// reference's 20 x 13-bit radix, which exists only because the TPU has no
// 64-bit multiplier; this core uses the card's 32x32->64 multiply instead:
// ten unsigned 32-bit limbs in radix 2^25.5 (the ref10 / donna-c32 layout),
// limb i holding bits [off(i), off(i) + width(i)) of the value, width 26 for
// even i and 25 for odd i. A product's columns are summed in uint64.
//
// Limb bounds (the executable interval proof, in the manner of
// tests/test_bounds.py, is `_check_wide_core_bounds` in
// tests/test_torch_ladder_host.py; it models every function below):
//   TIGHT: limb i < 2^width(i), except that limbs 1 and 5 may exceed it by
//          a carry (< 2^width + 2^11). mul, sqr, mul_small_add, from_bytes,
//          one and canon return TIGHT limbs.
//   LOOSE: limb i < its TIGHT bound + 2^(width(i) + 1), which is about
//          3 * 2^width(i). add and sub take TIGHT operands and
//          return LOOSE limbs; mul, sqr and mul_small_add take LOOSE ones.
// The ladder and the inversion only ever add or subtract outputs of mul,
// sqr, mul_small_add or from_bytes, and the proof shows that, under these
// bounds, no 32-bit pre-scaled operand (19g, 38f, 2f) and no 64-bit column
// or carry overflows, and that sub never goes below zero. The Edwards
// formulas (edwards25519_wide.cuh) also add to negations and subtract from
// them: neg of TIGHT limbs stays below 2p digit by digit, and weak_carry
// brings limbs below 2^31 back to TIGHT; the proof models those formulas op
// by op too, and shows where a sub of a LOOSE subtrahend cannot wrap.
//
// Constant time: no branch and no index depends on a limb value. Every
// loop has static bounds and is fully unrolled (the inversion's squaring
// runs are rolled loops of fixed count), so limb indices are compile-time
// constants and the arrays stay in registers.
//
// The same source builds with g++ for the CPU tests (fe_wide_op_host in
// ladder.cu): the CUDA attributes become empty there.

#pragma once

#include <stdint.h>

#ifndef FE_HD
#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif
#define FE_HD __host__ __device__ __forceinline__
#endif

namespace fe_wide {

constexpr int NLIMBS = 10;
constexpr uint32_t A24 = 121665;

// Limb i: `width(i)` bits from bit `offset(i)`; offset(10) = 255.
FE_HD constexpr int width(int i) { return 26 - (i & 1); }
FE_HD constexpr int offset(int i) { return 26 * ((i + 1) / 2) + 25 * (i / 2); }
FE_HD constexpr uint32_t mask(int i) { return (1u << width(i)) - 1; }
// Digits of 2p = 2^256 - 38, added by sub so that it stays non-negative.
FE_HD constexpr uint32_t two_p(int i) {
  return i == 0 ? (1u << 27) - 38 : (2u << width(i)) - 2;
}

struct Fe {
  uint32_t v[NLIMBS];
};

FE_HD uint64_t mul32(uint32_t a, uint32_t b) { return (uint64_t)a * b; }

// A limb as a 32-bit multiply operand. nvcc otherwise rebuilds a limb that
// came out of 64-bit columns, and the adds and subtracts on it, as a 64-bit
// value and multiplies it as one, with an IMAD more per product for its high
// word (a fifth more FMA-pipe work in the ladder). An identity byte
// permutation (PRMT, on the ALU pipe) is an op it cannot see through; on the
// host the identity itself.
FE_HD uint32_t operand(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, 0, 0x3210);
#else
  return x;
#endif
}

FE_HD Fe operands(const Fe& x) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = operand(x.v[i]);
  return r;
}

FE_HD Fe one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = i == 0;
  return r;
}

FE_HD Fe add(const Fe& x, const Fe& y) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = x.v[i] + y.v[i];
  return r;
}

// x + 2p - y: non-negative for a TIGHT y.
FE_HD Fe sub(const Fe& x, const Fe& y) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = x.v[i] + two_p(i) - y.v[i];
  return r;
}

// 2p - y: non-negative and below 2p digit by digit for a TIGHT y (the
// negation of 0 is 2p, which canon takes to 0).
FE_HD Fe neg(const Fe& y) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = two_p(i) - y.v[i];
  return r;
}

// One carry of 64-bit column i into column i + 1 (column 9's, times 19,
// into column 0: 2^255 = 19 mod p).
FE_HD void carry_col(uint64_t (&h)[NLIMBS], int i) {
  const uint64_t c = h[i] >> width(i);
  h[i] &= mask(i);
  if (i == NLIMBS - 1)
    h[0] += 19 * c;
  else
    h[i + 1] += c;
}

// The k-th carry of reduce_cols: ref10's two interleaved chains, 0 1 2 3
// and 4 5 6 7, then 4 8 9 0 (0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0).
FE_HD constexpr int carry_order(int k) {
  return k < 8 ? ((k & 1) ? 4 + k / 2 : k / 2)
               : (k == 8 ? 4 : (k == 9 ? 8 : (k == 10 ? 9 : 0)));
}

// Columns -> TIGHT limbs: twelve carries in two interleaved chains, for
// instruction-level parallelism.
FE_HD Fe reduce_cols(uint64_t (&h)[NLIMBS]) {
#pragma unroll
  for (int k = 0; k < 12; k++) carry_col(h, carry_order(k));
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = (uint32_t)h[i];
  return r;
}

// Limbs below 2^31 -> TIGHT limbs of the same value: reduce_cols's twelve
// carries in 32 bits.
FE_HD Fe weak_carry(const Fe& x) {
  uint32_t h[NLIMBS];
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) h[i] = x.v[i];
#pragma unroll
  for (int k = 0; k < 12; k++) {
    const int i = carry_order(k);
    const uint32_t c = h[i] >> width(i);
    h[i] &= mask(i);
    if (i == NLIMBS - 1)
      h[0] += 19 * c;
    else
      h[i + 1] += c;
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = h[i];
  return r;
}

// 100 products. Limb i of x times limb j of y lands at bit off(i) + off(j),
// which is off(i + j) plus one when i and j are both odd (the factor 2 goes
// on x), and past bit 255 when i + j >= 10 (the factor 19 goes on y).
FE_HD Fe mul(const Fe& x_in, const Fe& y_in) {
  const Fe x = operands(x_in), y = operands(y_in);
  uint32_t x2[NLIMBS], y19[NLIMBS];
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    x2[i] = 2 * x.v[i];
    y19[i] = 19 * y.v[i];
  }
  uint64_t h[NLIMBS];
#pragma unroll
  for (int k = 0; k < NLIMBS; k++) {
    h[k] = 0;
#pragma unroll
    for (int i = 0; i < NLIMBS; i++) {
      const int j = (k - i + NLIMBS) % NLIMBS;
      const uint32_t a = (i & j & 1) ? x2[i] : x.v[i];
      const uint32_t b = i > k ? y19[j] : y.v[j];
      h[k] += mul32(a, b);
    }
  }
  return reduce_cols(h);
}

// 55 products: each pair i < j once, with the factor 2 of the pair and
// the factors of mul folded into one operand each (ref10's fe_sq).
FE_HD Fe sqr(const Fe& x_in) {
  const Fe x = operands(x_in);
  uint32_t x2[NLIMBS], x19[NLIMBS], x38[NLIMBS];
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    x2[i] = 2 * x.v[i];
    x19[i] = 19 * x.v[i];
    x38[i] = 38 * x.v[i];
  }
  uint64_t h[NLIMBS];
#pragma unroll
  for (int k = 0; k < NLIMBS; k++) h[k] = 0;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
#pragma unroll
    for (int j = i; j < NLIMBS; j++) {
      // coefficient (i < j ? 2 : 1) * (i, j odd ? 2 : 1) * (wrap ? 19 : 1)
      const bool wrap = i + j >= NLIMBS, odd = i & j & 1, pair = i < j;
      uint32_t a, b;
      if (!wrap) {
        a = pair || odd ? x2[i] : x.v[i];
        b = pair && odd ? x2[j] : x.v[j];
      } else if (j & 1) {            // 38 x_j carries a 2 of its own
        a = pair && odd ? x2[i] : x.v[i];
        b = pair || odd ? x38[j] : x19[j];
      } else {                       // j even, so x_i is not odd-odd
        a = pair ? x2[i] : x.v[i];
        b = x19[j];
      }
      h[(i + j) % NLIMBS] += mul32(a, b);
    }
  }
  return reduce_cols(h);
}

// x + c * y for a constant c < 2^17 (the ladder's a24 = 121665): ten
// products with x as their addend, then the carry chains.
FE_HD Fe mul_small_add(const Fe& x, uint32_t c, const Fe& y) {
  uint64_t h[NLIMBS];
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) h[i] = mul32(c, operand(y.v[i])) + x.v[i];
  return reduce_cols(h);
}

// a where s == 1 else b, for s in {0, 1}: mask arithmetic, no branch.
FE_HD Fe select(uint32_t s, const Fe& a, const Fe& b) {
  const uint32_t m = 0u - s;
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = b.v[i] ^ ((a.v[i] ^ b.v[i]) & m);
  return r;
}

FE_HD Fe sqr_times(Fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; i++) x = sqr(x);
  return x;
}

// x^(2^250 - 1), with x^11 in x11: the shared prefix of the p - 2 and
// (p - 5) / 8 chains (fe25519::chain_2_250).
FE_HD Fe chain_2_250(const Fe& x, Fe& x11) {
  const Fe x2 = sqr(x);
  const Fe x9 = mul(sqr(sqr(x2)), x);
  x11 = mul(x9, x2);
  const Fe x31 = mul(sqr(x11), x9);            // 2^5 - 1
  Fe t = mul(sqr_times(x31, 5), x31);          // 2^10 - 1
  const Fe x10 = t;
  t = mul(sqr_times(t, 10), t);                // 2^20 - 1
  t = mul(sqr_times(t, 20), t);                // 2^40 - 1
  t = mul(sqr_times(t, 10), x10);              // 2^50 - 1
  const Fe x50 = t;
  t = mul(sqr_times(t, 50), t);                // 2^100 - 1
  t = mul(sqr_times(t, 100), t);               // 2^200 - 1
  return mul(sqr_times(t, 50), x50);           // 2^250 - 1
}

// 1/x = x^(p-2) (0 for x = 0): 254 squarings and 11 multiplies, the DJB
// chain of fe25519::inv.
FE_HD Fe inv(const Fe& x) {
  Fe x11;
  const Fe t = chain_2_250(x, x11);
  return mul(sqr_times(t, 5), x11);            // (2^250 - 1) * 2^5 + 11
}

// x^(2^252 - 3) = x^((p - 5) / 8) (fe25519::pow2523).
FE_HD Fe pow2523(const Fe& x) {
  Fe x11;
  const Fe t = chain_2_250(x, x11);
  return mul(sqr_times(t, 2), x);              // (2^250 - 1) * 4 + 1
}

// Sequential carries of limbs 0..8 into their next limb (32-bit).
FE_HD void carry_seq(uint32_t (&h)[NLIMBS]) {
#pragma unroll
  for (int i = 0; i < NLIMBS - 1; i++) {
    h[i + 1] += h[i] >> width(i);
    h[i] &= mask(i);
  }
}

// The canonical representative in [0, p) of LOOSE (or TIGHT) limbs, with
// every limb < 2^width(i). One carry pass with the fold leaves a value
// V < 2p; q = floor((V + 19) / 2^255), which is 1 iff V >= p, comes out of
// an exact carry chain over V + 19; then V + 19q - 2^255 q = V - qp.
FE_HD Fe canon(const Fe& x) {
  uint32_t h[NLIMBS];
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) h[i] = x.v[i];
  carry_seq(h);
  h[0] += 19 * (h[9] >> 25);
  h[9] &= mask(9);
  h[1] += h[0] >> 26;
  h[0] &= mask(0);
  uint32_t q = (h[0] + 19) >> 26;
#pragma unroll
  for (int i = 1; i < NLIMBS; i++) q = (h[i] + q) >> width(i);
  h[0] += 19 * q;
  carry_seq(h);
  h[9] &= mask(9);                             // drops q * 2^255
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = h[i];
  return r;
}

// 1 where x == 0 (mod p), else 0, for LOOSE (or TIGHT) limbs.
FE_HD uint32_t is_zero(const Fe& x) {
  const Fe c = canon(x);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) acc |= c.v[i];
  return acc == 0;
}

// A constant's canonical limbs.
FE_HD Fe fe_const(const uint32_t (&t)[NLIMBS]) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = t[i];
  return r;
}

// sqrt(-1) mod p (config.SQRT_M1).
FE_HD Fe sqrt_m1() {
  constexpr uint32_t t[NLIMBS] = {34513072, 25610706, 9377949,  3500415,  12389472,
                                  33281959, 41962654, 31548777, 326685,   11406482};
  return fe_const(t);
}

// x = sqrt(u/v) where u/v is a square, with ok = 1 there and 0 elsewhere,
// for LOOSE u and v (fe25519::sqrt_ratio, the same ops in the same order):
// x = u v^3 (u v^7)^((p-5)/8), then the sqrt(-1) fix-up, both checks by
// is_zero. u is carried to TIGHT first, for the checks' subtractions.
FE_HD Fe sqrt_ratio(const Fe& u_in, const Fe& v, uint32_t& ok) {
  const Fe u = weak_carry(u_in);
  const Fe v2 = sqr(v);
  const Fe v3 = mul(v2, v);
  const Fe a = mul(u, v3);                     // u v^3
  const Fe b = mul(a, sqr(v2));                // u v^7
  Fe x = mul(pow2523(b), a);
  const uint32_t good = is_zero(sub(mul(sqr(x), v), u));
  x = select(good, x, mul(x, sqrt_m1()));
  ok = good | is_zero(sub(mul(sqr(x), v), u));
  return x;
}

// Eight little-endian 32-bit words -> TIGHT limbs of bits 0..254 (bit 255
// is not read), NOT reduced mod p.
FE_HD Fe from_words(const uint32_t (&w)[8]) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    const int k = offset(i) / 32, s = offset(i) % 32;
    uint32_t t = w[k] >> s;
    if (s + width(i) > 32) t |= w[k + 1] << (32 - s);
    r.v[i] = t & mask(i);
  }
  return r;
}

// 32 little-endian bytes -> TIGHT limbs of bits 0..254 (bit 255 is not
// read), NOT reduced mod p: a u in [p, 2^255) stays as it is.
FE_HD Fe from_bytes(const uint8_t* b) {
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; k++)
    w[k] = (uint32_t)b[4 * k] | (uint32_t)b[4 * k + 1] << 8 |
           (uint32_t)b[4 * k + 2] << 16 | (uint32_t)b[4 * k + 3] << 24;
  return from_words(w);
}

// Limbs with every limb < 2^width(i) (canon's) -> their value as eight
// little-endian 32-bit words.
FE_HD void to_words(uint32_t (&w)[8], const Fe& c) {
#pragma unroll
  for (int k = 0; k < 8; k++) w[k] = 0;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    const int k = offset(i) / 32, s = offset(i) % 32;
    w[k] |= c.v[i] << s;
    if (s + width(i) > 32) w[k + 1] |= c.v[i] >> (32 - s);
  }
}

// The canonical value's 32 little-endian bytes (bit 255 clear).
FE_HD void to_bytes(uint8_t* out, const Fe& x) {
  uint32_t w[8];
  to_words(w, canon(x));
#pragma unroll
  for (int j = 0; j < 32; j++) out[j] = (uint8_t)(w[j / 4] >> (8 * (j % 4)));
}

// ---------------------------------------------------------------------------
// The 13-bit radix where it crosses a kernel: fe25519.cuh's twenty limbs,
// limb k holding bits [13k, 13k + 13) (the q_table's int8 planes).
// ---------------------------------------------------------------------------
constexpr int kLimbs13 = 20;

// Eight little-endian words of a value below 2^260 -> its twenty 13-bit
// limbs, each in [0, 2^13).
FE_HD void limbs13_from_words(int32_t (&out)[kLimbs13], const uint32_t (&w)[8]) {
#pragma unroll
  for (int k = 0; k < kLimbs13; k++) {
    const int j = 13 * k / 32, s = 13 * k % 32;
    uint32_t t = w[j] >> s;
    if (s + 13 > 32 && j + 1 < 8) t |= w[j + 1] << (32 - s);
    out[k] = (int32_t)(t & 0x1FFF);
  }
}

// Canonical limbs (canon's) -> the twenty 13-bit limbs of the same value,
// each in [0, 2^13): fe25519's canonical limbs.
FE_HD void to_limbs13(int32_t (&out)[kLimbs13], const Fe& c) {
  uint32_t w[8];
  to_words(w, c);
  limbs13_from_words(out, w);
}

// Twenty 13-bit limbs, each in [0, 2^13), of a value below 2^256 -> its
// eight little-endian words.
FE_HD void words_from_limbs13(uint32_t (&w)[8], const int32_t* limb) {
#pragma unroll
  for (int k = 0; k < 8; k++) w[k] = 0;
#pragma unroll
  for (int k = 0; k < kLimbs13; k++) {
    const int j = 13 * k / 32, s = 13 * k % 32;
    w[j] |= (uint32_t)limb[k] << s;
    if (s + 13 > 32 && j + 1 < 8) w[j + 1] |= (uint32_t)limb[k] >> (32 - s);
  }
}

// Twenty 13-bit limbs, each in [0, 2^13), of a value below 2^255 (such as
// fe25519's canonical limbs) -> TIGHT limbs of that value.
FE_HD Fe from_limbs13(const int32_t (&limb)[kLimbs13]) {
  uint32_t w[8];
  words_from_limbs13(w, limb);
  return from_words(w);
}

}  // namespace fe_wide
