// fe25519_f64.cuh -- multiply mod p = 2^255 - 19 for one lane on the FP64
// pipe (`DFMA`, fma.rn.f64 on sm_90a), beside the integer core.
//
// The ladder (csrc/ladder.cu) runs most of its field work on
// fe25519_wide.cuh's 32x32->64 products (`IMAD.WIDE.U32`, the FMA pipe) and
// three of a step's five multiplies here, so that one step keeps both of
// the card's exact multipliers busy: the FP64 pipe issues 64 products a
// clock an SM, twice the rate of IMAD.WIDE, and sits idle otherwise. A
// multiply takes fe_wide limbs and returns fe_wide limbs:
//   - the move in: each operand's LOOSE limbs (any limbs below
//     2^32 - 2^25, in fact) are carried once, all limbs at once, to balanced
//     limbs in [-2^(w-1), 2^(w-1)] plus a small carry (w = width(i)) on the
//     integer pipe; each becomes a double by its bits (2^52 + v), less a
//     constant, one DADD;
//   - 100 products into 19 columns: column k holds the products of limbs
//     i + j = k, at bit offset(k) (a column k >= 10 is past bit 255 and
//     stands for 19 times that at column k - 10), the odd-odd ones twice;
//   - columns 18..10 are cut at their width to the nearest multiple (a
//     rounding add of 1.5 * 2^(52 + w)) as soon as they are whole, the rest
//     folded by 19 into column k - 10 and the multiple, by 19 / 2^w, into
//     column k - 9; then column 9, whose multiple goes by 19 into column 0;
//   - a floor carry chain 0, 1, ..., 9, 0 (add.rm.f64 of the same constant)
//     gives limbs in [0, 2^width), limb 1 at most 2^25: TIGHT. Each limb
//     comes out as 2^52 + limb, whose low word is the limb.
// Every product, column, partial sum, carry and move is an integer below
// 2^53 in magnitude, so no operation rounds but the two kinds of cut, whose
// roundings are the point; contraction or the order of a sum cannot change a
// bit. The executable interval proof is `_check_f64_mul_bounds` in
// tests/test_torch_ladder_host.py: it models every operation below, and
// shows that balanced limbs are needed (unsigned ones pass 2^53) and that
// the bias of column 9 is (without it limb 1 can go below zero).
//
// A squaring the same way has 55 products and the same moves and carries,
// some 113 operations besides its products: on the card it costs as much as
// fe_wide::sqr, so the squarings stay on the integer core.
//
// Constant time: no branch and no index depends on a limb value; FP64
// operations take the same time whatever their operands on sm_90.
//
// The same source builds with g++ for the CPU tests (fe_wide_op_host in
// ladder.cu), whose doubles are IEEE binary64 (no -ffast-math): the card's
// intrinsics become the same operations of the C++ library there, and
// add.rm.f64, which the host lacks, a round-to-nearest add stepped down
// where its exact error (TwoSum) shows that it rounded up.

#pragma once

#include <string.h>

#include <cmath>

#include "fe25519_wide.cuh"

namespace fe_f64 {

using fe_wide::Fe;
using fe_wide::NLIMBS;
using fe_wide::width;

constexpr int kCols = 2 * NLIMBS - 1;                     // columns 0..18
constexpr int kMulProducts = NLIMBS * NLIMBS;             // 100

// IEEE binary64 operations, each rounded once.
FE_HD double dadd(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}

FE_HD double dfma(double a, double b, double c) {
#ifdef __CUDA_ARCH__
  return __fma_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}

// a + b rounded toward minus infinity.
FE_HD double dadd_down(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rd(a, b);
#else
  const double s = a + b, bb = s - a;
  const double err = (a - (s - bb)) + (b - bb);
  return err < 0 ? std::nextafter(s, -INFINITY) : s;
#endif
}

// 2^52 + v: the double whose high word is 0x43300000 and low word v.
FE_HD double biased(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __hiloint2double(0x43300000, (int)v);
#else
  const uint64_t bits = (uint64_t)0x43300000 << 32 | v;
  double d;
  memcpy(&d, &bits, sizeof d);
  return d;
#endif
}

// The low word of x = 2^52 + v for an integer v in [0, 2^32): v.
FE_HD uint32_t low_word(double x) {
#ifdef __CUDA_ARCH__
  return (uint32_t)__double2loint(x);
#else
  uint64_t bits;
  memcpy(&bits, &x, sizeof bits);
  return (uint32_t)bits;
#endif
}

// Constants by the width of limb or column k (26 for even k, 25 for odd).
FE_HD constexpr double pow2w(int k) { return (k & 1) ? 0x1p25 : 0x1p26; }
FE_HD constexpr double inv2w(int k) { return (k & 1) ? 0x1p-25 : 0x1p-26; }
// Added to |c| < 2^(51 + w), it leaves a sum of exponent 52 + w: c rounded
// to a multiple of 2^w, in the rounding of the add.
FE_HD constexpr double magic(int k) { return 0x1.8p52 * pow2w(k); }

// Limb k of the floor chain comes out as lo_k + chain_offset(k): 2^52, so
// that its low word is the limb; limb 0's first lo also holds 19 * 2^27,
// which the carry from limb 9 takes back (it arrives as 19 (carry - 2^27));
// limb 1's holds 2^26 more, which the last carry from limb 0 takes back.
FE_HD constexpr double chain_offset(int k) {
  return k == 0 ? 19 * 0x1p27 : (k == 1 ? 0x1p52 + 0x1p26 : 0x1p52);
}
// Column k's start: what the chain's carry into it leaves out
// (chain_offset(k - 1) / 2^width(k - 1)).
FE_HD constexpr double col_start(int k) {
  return k >= 1 && k < NLIMBS ? chain_offset(k - 1) * inv2w(k - 1) : 0;
}
// What column 9 keeps when it is cut: its start, and a bias of 2^29 (column
// 0 gets -19 / 2^25 times the bias, so the value moves by a multiple of p),
// which keeps the chain's carry out of limb 9 non-negative.
constexpr double kCol9Keep = 0x1p29 + col_start(NLIMBS - 1);

// The move in: balanced limbs y of x's value and 2y, each an integer-valued
// double. x's limbs are carried once, all at once (t = x + 2^(w-1): carry
// t >> w, rest t mod 2^w), and limb i becomes rest_i - 2^(w-1) plus the
// carry out of limb i - 1 (19 times limb 9's, into limb 0).
FE_HD void to_balanced(double (&y)[NLIMBS], double (&y2)[NLIMBS], const Fe& x) {
  uint32_t rest[NLIMBS], carry[NLIMBS];
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    const uint32_t t = x.v[i] + (1u << (width(i) - 1));
    carry[i] = t >> width(i);
    rest[i] = t & fe_wide::mask(i);
  }
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    const uint32_t in = (i == 0 ? 19u : 1u) * carry[(i + NLIMBS - 1) % NLIMBS];
    const double b = biased(rest[i] + in);
    const double bias = 0x1p52 + 0.5 * pow2w(i);
    y[i] = dadd(b, -bias);
    y2[i] = dfma(b, 2.0, -2 * bias);
  }
}

// The move out: limbs held as 2^52 + limb -> fe_wide limbs.
FE_HD Fe limbs_of(const double (&out)[NLIMBS]) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = low_word(out[i]);
  return r;
}

// acc plus column k's products: limb i of x (y) times limb j = k - i of w
// (z), twice (z2) where both are odd: limb i times limb j lands at
// offset(i + j) plus one then.
FE_HD double column(const double (&y)[NLIMBS], const double (&z)[NLIMBS],
                    const double (&z2)[NLIMBS], int k, double acc) {
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    const int j = k - i;
    if (j < 0 || j >= NLIMBS) continue;
    acc = dfma(y[i], (i & j & 1) ? z2[j] : z[j], acc);
  }
  return acc;
}

// x * w for LOOSE x and w: TIGHT limbs (see the top of the file).
FE_HD Fe mul(const Fe& x, const Fe& w) {
  double y[NLIMBS], y2[NLIMBS], z[NLIMBS], z2[NLIMBS];
  to_balanced(y, y2, x);                           // y2 is not read
  to_balanced(z, z2, w);

  // Columns 18..10, each cut when whole, so that only columns 0..9 stay
  // live: the nearest multiple of 2^w and the rest; the rest goes by 19
  // into column k - 10, the multiple by 19 / 2^w into column k + 1 - 10.
  double col[NLIMBS];
#pragma unroll
  for (int k = 0; k < NLIMBS; k++) col[k] = col_start(k);
#pragma unroll
  for (int k = kCols - 1; k >= NLIMBS; k--) {
    const double c = column(y, z, z2, k, 0.0);
    const double up = dadd(dadd(c, magic(k)), -magic(k));
    col[k - NLIMBS] = dfma(dadd(c, -up), 19.0, col[k - NLIMBS]);
    col[k - 9] = dfma(up, 19 * inv2w(k), col[k - 9]);
  }
#pragma unroll
  for (int k = 0; k < NLIMBS; k++) col[k] = column(y, z, z2, k, col[k]);

  // Column 9, whole: its nearest multiple of 2^25, less kCol9Keep, by
  // 19 / 2^25 into column 0 (2^255 = 19 mod p).
  const double up9 = dadd(dadd(col[9], magic(9)), -(magic(9) + kCol9Keep));
  col[9] = dadd(col[9], -up9);
  col[0] = dfma(up9, 19 * inv2w(9), col[0]);

  // The floor chain 0, 1, ..., 9, then limb 0 once more into limb 1.
  double out[NLIMBS];
#pragma unroll
  for (int k = 0; k < NLIMBS; k++) {
    const double r = dadd_down(col[k], magic(k));
    const double t = dadd(r, -(magic(k) + chain_offset(k)));
    out[k] = dadd(col[k], -t);
    if (k < NLIMBS - 1)
      col[k + 1] = dfma(t, inv2w(k), col[k + 1]);
    else
      out[0] = dfma(t, 19 * inv2w(k), out[0]);
  }
  const double r = dadd_down(out[0], magic(0));
  const double t = dadd(r, -(magic(0) + 0x1p52));
  out[0] = dadd(out[0], -t);
  out[1] = dfma(t, inv2w(0), out[1]);
  return limbs_of(out);
}

}  // namespace fe_f64
