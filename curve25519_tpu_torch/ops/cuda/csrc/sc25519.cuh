// sc25519.cuh -- scalar arithmetic mod l = 2^252 + 27742317777372353535851937790883648493
// for one lane, limbs in registers.
//
// Replaces the TPU package's in-kernel mod-l library
// curve25519_tpu/ops/pallas/sc_tile.py (sc_carry, sc_canon, sc_reduce40,
// sc_mod, sc_add, sc_mul, sc_muladd, sc_from_digest_rows, clamp_rows;
// cut8_rows is fold_wide.cuh's CombDigits). The integer steps are those of curve25519_tpu_torch/ops/sc.py
// (and of the JAX ops/sc.py): 20 limbs of 13 bits, the FOLD_SC matrix that
// folds the high 20 limbs of a 40-limb value down in one step, and the
// l = 2^252 + delta canonicalization. So the host build is compared limb
// for limb with the port's ops/sc.py. Every limb loop has static bounds and
// is unrolled, so the constant tables below fold into immediates.

#pragma once

#include "fe25519.cuh"

namespace sc25519 {

using fe25519::BITS;
using fe25519::Fe;
using fe25519::MASK;
using fe25519::NLIMBS;

// limbs of l, and of delta = l - 2^252 (the same digits, top limb 0)
FE_HD int32_t ell_limb(int i) {
  constexpr int32_t t[20] = {5101, 1966, 1687, 1222, 1409, 3691, 3038, 7124, 7929, 166,
                             0,    0,    0,    0,    0,    0,    0,    0,    0,    32};
  return t[i];
}
FE_HD int32_t delta_limb(int i) { return i == NLIMBS - 1 ? 0 : ell_limb(i); }

// limbs of 2^260 mod l
FE_HD int32_t r260_limb(int i) {
  constexpr int32_t t[20] = {1773, 6415, 3929, 7825, 1114, 831,  3435, 1909, 1307, 6575,
                             8186, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 31};
  return t[i];
}

// FOLD_SC[i][j] = limb j of 2^(13*(20+i)) mod l
FE_HD int32_t fold_sc(int i, int j) {
  constexpr int32_t t[20][20] = {
      {1773, 6415, 3929, 7825, 1114, 831, 3435, 1909, 1307, 6575, 8186, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 31},
      {5101, 6830, 6135, 3464, 8012, 3396, 178, 7521, 2714, 1736, 6408, 8186, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 31},
      {5101, 1966, 6551, 5670, 3651, 2102, 2744, 4264, 134, 3144, 1569, 6408, 8186, 8191, 8191, 8191, 8191, 8191, 8191, 31},
      {5101, 1966, 1687, 6086, 5857, 5933, 1449, 6830, 5069, 563, 2977, 1569, 6408, 8186, 8191, 8191, 8191, 8191, 8191, 31},
      {5101, 1966, 1687, 1222, 6273, 8139, 5280, 5535, 7635, 5498, 396, 2977, 1569, 6408, 8186, 8191, 8191, 8191, 8191, 31},
      {5101, 1966, 1687, 1222, 1409, 363, 7487, 1174, 6341, 8064, 5331, 396, 2977, 1569, 6408, 8186, 8191, 8191, 8191, 31},
      {5101, 1966, 1687, 1222, 1409, 3691, 7902, 3380, 1980, 6770, 7897, 5331, 396, 2977, 1569, 6408, 8186, 8191, 8191, 31},
      {5101, 1966, 1687, 1222, 1409, 3691, 3038, 3796, 4186, 2409, 6603, 7897, 5331, 396, 2977, 1569, 6408, 8186, 8191, 31},
      {5101, 1966, 1687, 1222, 1409, 3691, 3038, 7124, 4601, 4615, 2242, 6603, 7897, 5331, 396, 2977, 1569, 6408, 8186, 31},
      {5101, 1966, 1687, 1222, 1409, 3691, 3038, 7124, 7929, 5030, 4448, 2242, 6603, 7897, 5331, 396, 2977, 1569, 6408, 26},
      {7384, 5967, 1352, 2659, 6655, 8013, 4329, 7247, 2049, 1885, 4891, 4448, 2242, 6603, 7897, 5331, 396, 2977, 1569, 8},
      {1955, 3952, 6769, 2482, 4985, 7707, 1566, 6732, 8070, 4173, 1842, 4891, 4448, 2242, 6603, 7897, 5331, 396, 2977, 1},
      {5607, 3731, 4929, 6203, 2209, 2910, 4056, 5529, 8103, 7142, 4166, 1842, 4891, 4448, 2242, 6603, 7897, 5331, 396, 1},
      {996, 2840, 2111, 5058, 5383, 4207, 7805, 3460, 2052, 4316, 7137, 4166, 1842, 4891, 4448, 2242, 6603, 7897, 5331, 12},
      {6226, 6447, 3620, 1344, 5177, 5496, 4296, 7764, 270, 2082, 4250, 7137, 4166, 1842, 4891, 4448, 2242, 6603, 7897, 19},
      {834, 176, 2635, 452, 1360, 1272, 2854, 4009, 3762, 7224, 1977, 4250, 7137, 4166, 1842, 4891, 4448, 2242, 6603, 25},
      {4682, 1836, 3580, 6054, 5916, 5061, 7859, 2299, 7130, 6691, 7089, 1977, 4250, 7137, 4166, 1842, 4891, 4448, 2242, 11},
      {7730, 6064, 6701, 7045, 2481, 2794, 1533, 653, 5144, 396, 6633, 7089, 1977, 4250, 7137, 4166, 1842, 4891, 4448, 2},
      {5201, 5410, 5399, 5669, 7193, 7976, 7226, 239, 7460, 2943, 383, 6633, 7089, 1977, 4250, 7137, 4166, 1842, 4891, 0},
      {2888, 1186, 2902, 8040, 4470, 3191, 4884, 5666, 7315, 6656, 2940, 383, 6633, 7089, 1977, 4250, 7137, 4166, 1842, 27}};
  return t[i][j];
}

// Canonicalize value = d + c * 2^260 (d normalized, 0 <= c < 2^12) into
// [0, l): subtract q*l through l = 2^252 + delta, add l back where negative.
FE_HD Fe canon(const Fe& d, int32_t c) {
  const int32_t q = (d.v[NLIMBS - 1] >> 5) + (c << 8);  // value >> 252
  Fe t, td, u, ud;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    const int32_t di = i == NLIMBS - 1 ? (d.v[i] & 0x1F) : d.v[i];
    t.v[i] = di - q * delta_limb(i);
  }
  const int32_t tc = fe25519::carry_seq(td, t);
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) u.v[i] = td.v[i] + ell_limb(i);
  fe25519::carry_seq(ud, u);
  return fe25519::select((tc >> 31) & 1, ud, td);
}

// Reduce 40 normalized-or-small columns mod l: fold the high 20 down with
// FOLD_SC (every column stays below 2^31), two exact carries, canon.
FE_HD Fe reduce40(const int32_t (&cols)[2 * NLIMBS]) {
  Fe r, d2, r2, d3;
#pragma unroll
  for (int k = 0; k < NLIMBS; k++) {
    int32_t acc = cols[k];
#pragma unroll
    for (int i = 0; i < NLIMBS; i++) acc += cols[NLIMBS + i] * fold_sc(i, k);
    r.v[k] = acc;
  }
  const int32_t c2 = fe25519::carry_seq(d2, r);  // c2 < 2^11
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r2.v[i] = d2.v[i] + c2 * r260_limb(i);
  const int32_t c3 = fe25519::carry_seq(d3, r2);  // c3 <= ~11
  return sc25519::canon(d3, c3);
}

// Reduce a weakly normalized < ~2^260 value mod l.
FE_HD Fe mod(const Fe& x) {
  Fe d;
  const int32_t c = fe25519::carry_seq(d, x);
  return sc25519::canon(d, c);
}

// x + y mod l for canonical inputs.
FE_HD Fe add(const Fe& x, const Fe& y) {
  Fe s, d, t, td;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) s.v[i] = x.v[i] + y.v[i];
  fe25519::carry_seq(d, s);  // value < 2l < 2^254
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) t.v[i] = d.v[i] - ell_limb(i);
  const int32_t tc = fe25519::carry_seq(td, t);
  return fe25519::select((tc >> 31) & 1, d, td);
}

// x * y mod l: 39 schoolbook columns, exact carry to 39 digits plus the
// carry-out limb, reduce40.
FE_HD Fe mul(const Fe& x, const Fe& y) {
  int32_t c[2 * NLIMBS - 1];
#pragma unroll
  for (int k = 0; k < 2 * NLIMBS - 1; k++) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
#pragma unroll
    for (int j = 0; j < NLIMBS; j++) c[i + j] += x.v[i] * y.v[j];
  }
  int32_t wide[2 * NLIMBS];
  int32_t carry = 0;
#pragma unroll
  for (int k = 0; k < 2 * NLIMBS - 1; k++) {
    const int32_t t = c[k] + carry;
    wide[k] = t & MASK;
    carry = t >> BITS;
  }
  wide[2 * NLIMBS - 1] = carry;
  return reduce40(wide);
}

// x * y + z mod l (S = h * a + r of signing).
FE_HD Fe muladd(const Fe& x, const Fe& y, const Fe& z) {
  return sc25519::add(sc25519::mul(x, y), z);
}

// l - x for canonical x.
FE_HD Fe sub_from_ell(const Fe& x) {
  Fe t, d;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) t.v[i] = ell_limb(i) - x.v[i];
  fe25519::carry_seq(d, t);
  return d;
}

// 64 digest bytes (little-endian value) -> canonical scalar: limb i of the
// 40-limb view is bits [13i, 13i+13), inside the 3 bytes from (13i)/8.
FE_HD Fe from_digest(const int32_t (&b)[64]) {
  int32_t cols[2 * NLIMBS];
#pragma unroll
  for (int i = 0; i < 2 * NLIMBS; i++) {
    const int j = (BITS * i) / 8;
    const int s = (BITS * i) % 8;
    int32_t w = b[j];
    if (j + 1 < 64) w |= b[j + 1] << 8;
    if (j + 2 < 64) w |= b[j + 2] << 16;
    cols[i] = (w >> s) & MASK;
  }
  return reduce40(cols);
}

// RFC 7748 / 8032 clamping of 32 byte values.
FE_HD void clamp(int32_t (&b)[32]) {
  b[0] &= 0xF8;
  b[31] = (b[31] & 0x7F) | 0x40;
}

}  // namespace sc25519
