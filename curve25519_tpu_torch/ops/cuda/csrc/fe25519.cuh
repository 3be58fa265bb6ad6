// fe25519.cuh -- field arithmetic mod p = 2^255 - 19 for one lane, limbs in
// registers.
//
// Replaces the in-kernel field core of the TPU package,
// curve25519_tpu/ops/pallas/fe_tile.py (t_add, t_sub, t_neg, t_mul, t_sqr,
// t_mul_small_add, t_select, t_inv, t_canon, t_norm_to_bytes, t_to_bytes;
// t_pow2523, t_is_zero and verify_kernel._t_sqrt_ratio, which only verify
// uses, are fe25519_wide.cuh's, and t_pack_point edwards25519_wide.cuh's
// pack), and the byte->limb
// decode sc_tile.limbs_from_byte_rows. Where those work on [20, 8, 128] tiles
// of 1024 lanes, every function here works on the 20 limbs of ONE lane, held
// in registers: the CUDA kernel runs one lane per thread.
//
// The radix, bounds and op sequence are exactly those of ops/fe.py (20 limbs
// of 13 bits in int32, the SIGNED-WEAK invariant -1217 <= limb <= 9500 between
// ops, parallel carries, 2^260 = 608 fold), so each function returns the same
// limbs as its counterpart in curve25519_tpu_torch/ops/fe.py and the interval
// proof of tests/test_bounds.py covers it. Every loop over limbs has static
// bounds and is fully unrolled, so each limb index is a compile-time constant
// and the arrays stay in registers.
//
// The same source builds with g++ for the CPU tests: the CUDA attributes
// below become empty there. `>>` on a negative int is an arithmetic shift
// under both nvcc and g++, and `&` acts on the two's complement, as torch's
// and XLA's int32 ops do.

#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#define FE_HD __host__ __device__ __forceinline__

namespace fe25519 {

constexpr int BITS = 13;
constexpr int NLIMBS = 20;
constexpr int NCOLS = 2 * NLIMBS - 1;
constexpr int32_t MASK = (1 << BITS) - 1;
constexpr int32_t FOLD = 608;  // 2^260 mod p
constexpr int32_t A24 = 121665;

// Digits of the static pads (ops/fe.py _SUB_PAD, _P_LIMBS, _CANON_PAD).
// 32p with a borrow-raise: all digits but the top are >= 2^14 > 9500.
FE_HD int32_t sub_pad(int i) { return i == 0 ? 23968 : (i == 19 ? 8189 : 24573); }
// p = 2^255 - 19
FE_HD int32_t p_limb(int i) { return i == 0 ? 8173 : (i == 19 ? 255 : 8191); }
// 8p: lifts signed-weak digits non-negative before canon's exact carries
FE_HD int32_t canon_pad(int i) { return i == 0 ? 8040 : (i == 19 ? 2047 : 8191); }

struct Fe {
  int32_t v[NLIMBS];
};

// One parallel carry step with the wrap fold of limb 19's carry into limb 0.
FE_HD Fe wrap_carry(const Fe& r) {
  Fe z;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    int32_t cin = i == 0 ? (r.v[NLIMBS - 1] >> BITS) * FOLD : (r.v[i - 1] >> BITS);
    z.v[i] = (r.v[i] & MASK) + cin;
  }
  return z;
}

FE_HD Fe add(const Fe& x, const Fe& y) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = x.v[i] + y.v[i];
  return wrap_carry(r);
}

FE_HD Fe sub(const Fe& x, const Fe& y) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = x.v[i] - y.v[i] + sub_pad(i);
  return wrap_carry(r);
}

FE_HD Fe neg(const Fe& y) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = sub_pad(i) - y.v[i];
  return wrap_carry(r);
}

// 39 schoolbook columns (each |col| < 2^30.75) -> signed-weak limbs: one
// widening carry to 40 digits d, fold r = d[0:20] + 608 * d[20:40], two wrap
// carries (ops/fe.py _reduce_product).
FE_HD Fe reduce_cols(const int32_t (&cols)[NCOLS]) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    int32_t lo = (cols[i] & MASK) + (i > 0 ? (cols[i - 1] >> BITS) : 0);
    const int k = i + NLIMBS;
    int32_t hi = (k < NCOLS ? (cols[k] & MASK) : 0) + (cols[k - 1] >> BITS);
    r.v[i] = lo + FOLD * hi;
  }
  return wrap_carry(wrap_carry(r));
}

FE_HD Fe mul(const Fe& x, const Fe& y) {
  int32_t c[NCOLS];
#pragma unroll
  for (int k = 0; k < NCOLS; k++) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
#pragma unroll
    for (int j = 0; j < NLIMBS; j++) c[i + j] += x.v[i] * y.v[j];
  }
  return reduce_cols(c);
}

// Squaring with the pre-doubled operand s = x + x (|s| <= 19000): the
// columns equal mul(x, x)'s exactly, with ~210 products instead of 400.
FE_HD Fe sqr(const Fe& x) {
  int32_t c[NCOLS];
#pragma unroll
  for (int k = 0; k < NCOLS; k++) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    c[2 * i] += x.v[i] * x.v[i];
    const int32_t s = x.v[i] + x.v[i];
#pragma unroll
    for (int j = i + 1; j < NLIMBS; j++) c[i + j] += s * x.v[j];
  }
  return reduce_cols(c);
}

// z = x + c * y for a small constant c (c <= ~2^17): widen to 21 digits,
// fold digit 20 into limb 0, two wrap carries.
FE_HD Fe mul_small_add(const Fe& x, int32_t c, const Fe& y) {
  int32_t t[NLIMBS];
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) t[i] = x.v[i] + c * y.v[i];
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++)
    r.v[i] = (t[i] & MASK) + (i > 0 ? (t[i - 1] >> BITS) : 0);
  r.v[0] += FOLD * (t[NLIMBS - 1] >> BITS);
  return wrap_carry(wrap_carry(r));
}

// a where s == 1 else b, for s in {0, 1}: mask arithmetic, no branch.
FE_HD Fe select(int32_t s, const Fe& a, const Fe& b) {
  const int32_t m = -s;
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

// x^(2^250 - 1), with x^11 in x11: the shared prefix of the p-2 and (p-5)/8
// DJB chains (ops/fe.py _chain_2_250, fe_tile._t_chain_2_250).
FE_HD Fe chain_2_250(const Fe& x, Fe& x11) {
  Fe x2 = sqr(x);
  Fe x9 = mul(sqr(sqr(x2)), x);
  x11 = mul(x9, x2);
  Fe x31 = mul(sqr(x11), x9);                 // 2^5 - 1
  Fe t = mul(sqr_times(x31, 5), x31);         // 2^10 - 1
  Fe x10 = t;
  t = mul(sqr_times(t, 10), t);               // 2^20 - 1
  t = mul(sqr_times(t, 20), t);               // 2^40 - 1
  t = mul(sqr_times(t, 10), x10);             // 2^50 - 1
  Fe x50 = t;
  t = mul(sqr_times(t, 50), t);               // 2^100 - 1
  t = mul(sqr_times(t, 100), t);              // 2^200 - 1
  return mul(sqr_times(t, 50), x50);          // 2^250 - 1
}

// 1/x = x^(p-2): 254 squarings and 11 multiplies (ops/fe.py inv).
FE_HD Fe inv(const Fe& x) {
  Fe x11;
  const Fe t = chain_2_250(x, x11);
  return mul(sqr_times(t, 5), x11);           // (2^250 - 1) * 2^5 + 11
}

// Exact sequential signed carry: d gets digits in [0, 2^13); returns the
// carry out of limb 19.
FE_HD int32_t carry_seq(Fe& d, const Fe& x) {
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    int32_t t = x.v[i] + c;
    d.v[i] = t & MASK;
    c = t >> BITS;
  }
  return c;
}

// Canonical representative in [0, p) (ops/fe.py canon): 8p lift, exact carry,
// fold, exact carry, subtract q*p with q = value >> 255, then one conditional
// subtract of p chosen by mask.
FE_HD Fe canon(const Fe& x) {
  Fe t, d, d2, td, ud;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) t.v[i] = x.v[i] + canon_pad(i);
  const int32_t c = carry_seq(d, t);
  d.v[0] += FOLD * c;
  carry_seq(d2, d);
  const int32_t q = d2.v[NLIMBS - 1] >> 8;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) t.v[i] = d2.v[i] - q * p_limb(i);
  carry_seq(td, t);
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) t.v[i] = td.v[i] - p_limb(i);
  const int32_t uc = carry_seq(ud, t);       // -1 iff value < p
  return select(uc + 1, ud, td);
}

// 20 limbs from a row (stride 0 rows share one vector).
FE_HD Fe load_fe(const int32_t* p) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = p[i];
  return r;
}

// A constant's limbs.
FE_HD Fe fe_const(const int32_t (&t)[NLIMBS]) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = t[i];
  return r;
}

// Normalized limbs (digits in [0, 2^13), value < 2^256) -> little-endian
// bytes (values in [0, 256)). Byte j straddles limbs 8j/13 and 8j/13 + 1
// (ops/fe.py norm_to_bytes, fe_tile.t_norm_to_bytes).
FE_HD void norm_to_bytes(int32_t (&out)[32], const Fe& d) {
#pragma unroll
  for (int j = 0; j < 32; j++) {
    const int i = (8 * j) / BITS;
    const int s = 8 * j - BITS * i;
    const int32_t next = i + 1 < NLIMBS ? d.v[i + 1] : 0;
    out[j] = ((d.v[i] >> s) | (next << (BITS - s))) & 0xFF;
  }
}

// Weak limbs -> canonical little-endian bytes (ops/fe.py to_bytes).
FE_HD void to_bytes(int32_t (&out)[32], const Fe& x) { norm_to_bytes(out, canon(x)); }

// 32 little-endian bytes (already widened to int32) -> normalized limbs, NOT
// reduced mod p (ops/fe.py from_bytes, sc_tile.limbs_from_byte_rows).
FE_HD Fe from_bytes(const int32_t (&b)[32]) {
  Fe x;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    const int j = (BITS * i) / 8;
    const int s = (BITS * i) % 8;
    int32_t w = b[j];
    if (j + 1 < 32) w |= b[j + 1] << 8;
    if (j + 2 < 32) w |= b[j + 2] << 16;
    x.v[i] = (w >> s) & MASK;
  }
  return x;
}

}  // namespace fe25519
