// weak_limbs.cuh -- a field element that crosses a kernel as fe25519.cuh's
// twenty signed-weak 13-bit limbs (a randomizer zr, a blinding point's
// coordinates), taken to the wide core (fe25519_wide.cuh) once per lane.
//
// Shared by the ladder (csrc/ladder.cu) and the fold-4 base multiply
// (csrc/basemult.cu).

#pragma once

#include "fe25519.cuh"
#include "fe25519_wide.cuh"

// 20 signed-weak 13-bit limbs -> the same value in the wide radix: the
// canonical encoding by fe25519, decoded by fe_wide (TIGHT limbs, every limb
// below 2^width(i)). Only the value mod p crosses.
FE_HD fe_wide::Fe wide_from_weak_limbs(const int32_t* limbs) {
  fe25519::Fe z;
#pragma unroll
  for (int i = 0; i < fe25519::NLIMBS; i++) z.v[i] = limbs[i];
  int32_t enc[32];
  fe25519::to_bytes(enc, z);
  uint8_t b[32];
#pragma unroll
  for (int j = 0; j < 32; j++) b[j] = (uint8_t)enc[j];
  return fe_wide::from_bytes(b);
}
