// edwards25519.cuh -- twisted-Edwards point arithmetic and the folding
// base-point multiply for one lane on the 13-bit core: the lane of the base
// multiply's limb modes (`affine`, `mont_u`; csrc/basemult.cu), whose weak
// 13-bit limbs only this radix and this op order reproduce. The byte modes,
// keygen, sign and verify run on the wide core (fold_wide.cuh,
// edwards25519_wide.cuh).
//
// Replaces the device functions of curve25519_tpu/ops/pallas/edwards_kernel.py
// (_gather_pa, _double, _add_pa, _add_pe, the fold loop of _basemult_kernel)
// and sign_kernel._base_mult_from_scratch. The point formulas and the order
// of field ops are those of curve25519_tpu_torch/models/edwards.py, so every
// limb equals the plain version's.
//
// The folding table is indexed by secret scalar digits and must be read in
// constant time (the ROADMAP ground rule; on the TPU a one-hot MXU matmul).
// Here every lane reads EVERY entry in the same order and keeps the one whose
// index equals its digit with a mask: no load address and no branch depends
// on a digit. All lanes of a warp read the same entry at the same step, so
// the reads broadcast; the table is packed two 13-bit limbs per 32-bit word
// (limb 2k in bits 0..15, limb 2k+1 in bits 16..31 of word k, over the 60
// limbs ypx ++ ymx ++ t2d), 32 words per entry (the last two zero), which
// halves the selects of a gather (fold 4's 16 entries). Fold 8 reads its
// 256 entries as an int8 one-hot product on the tensor cores
// (gather_mma.cuh) and takes the canonical words to 13-bit limbs.

#pragma once

#include "fe25519.cuh"

namespace ed25519 {

using namespace fe25519;

constexpr int kEntryWords = 32;  // 30 packed words + 2 of padding

// Extended homogeneous point (X : Y : Z : T), T = XY/Z.
struct Ext {
  Fe x, y, z, t;
};

// 1/d mod p (config.ED_DI).
FE_HD Fe ed_di() {
  constexpr int32_t t[NLIMBS] = {6211, 3663, 7603, 484,  606,  2583, 2533, 4872, 7638, 4186,
                                 5081, 7027, 4428, 2832, 3244, 6600, 5333, 5776, 1055, 129};
  return fe_const(t);
}

// 2P, 4M + 4S (models/edwards.double).
FE_HD Ext dbl(const Ext& p) {
  const Fe a = sqr(p.x);
  const Fe b = sqr(p.y);
  Fe c = sqr(p.z);
  c = add(c, c);
  const Fe d = neg(a);
  const Fe h = sub(d, b);
  const Fe g = add(d, b);
  const Fe f = sub(g, c);
  const Fe e = add(sqr(add(p.x, p.y)), h);
  return {mul(e, f), mul(h, g), mul(g, f), mul(e, h)};
}

// P + Q for Q in affine precomputed form (Y+X, Y-X, 2dXY), 7M
// (models/edwards.add_pa).
FE_HD Ext add_pa(const Ext& p, const Fe& ypx, const Fe& ymx, const Fe& t2d) {
  const Fe a = mul(sub(p.y, p.x), ymx);
  const Fe b = mul(add(p.y, p.x), ypx);
  const Fe c = mul(p.t, t2d);
  const Fe d = add(p.z, p.z);
  const Fe e = sub(b, a);
  const Fe h = add(b, a);
  const Fe f = sub(d, c);
  const Fe g = add(d, c);
  return {mul(e, f), mul(h, g), mul(g, f), mul(e, h)};
}

// PE point (Y+X, Y-X, 2dT, 2Z) (models/edwards.to_pe).
struct Pe {
  Fe ypx, ymx, t2d, z2;
};

// P + Q for Q in PE form, 8M (models/edwards.add_pe).
FE_HD Ext add_pe(const Ext& p, const Pe& q) {
  const Fe a = mul(sub(p.y, p.x), q.ymx);
  const Fe b = mul(add(p.y, p.x), q.ypx);
  const Fe c = mul(p.t, q.t2d);
  const Fe d = mul(p.z, q.z2);
  const Fe e = sub(b, a);
  const Fe h = add(b, a);
  const Fe f = sub(d, c);
  const Fe g = add(d, c);
  return {mul(e, f), mul(h, g), mul(g, f), mul(e, h)};
}

// The same with Q as 80 limbs: ypx, ymx, t2d, z2.
FE_HD Ext add_pe(const Ext& p, const int32_t* q) {
  Pe e;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    e.ypx.v[i] = q[i];
    e.ymx.v[i] = q[NLIMBS + i];
    e.t2d.v[i] = q[2 * NLIMBS + i];
    e.z2.v[i] = q[3 * NLIMBS + i];
  }
  return add_pe(p, e);
}

// The 60 limbs ypx ++ ymx ++ t2d of packed entry words.
FE_HD void unpack_pa(Fe& ypx, Fe& ymx, Fe& t2d, const uint32_t (&acc)[kEntryWords]) {
  int32_t limb[3 * NLIMBS];
#pragma unroll
  for (int k = 0; k < 3 * NLIMBS / 2; k++) {
    limb[2 * k] = (int32_t)(acc[k] & 0xFFFF);
    limb[2 * k + 1] = (int32_t)(acc[k] >> 16);
  }
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    ypx.v[i] = limb[i];
    ymx.v[i] = limb[NLIMBS + i];
    t2d.v[i] = limb[2 * NLIMBS + i];
  }
}

// Constant-time fetch of entry `idx` of a packed table of NENT entries.
template <int NENT>
FE_HD void gather(Fe& ypx, Fe& ymx, Fe& t2d, const uint32_t* tbl, int32_t idx) {
  uint32_t acc[kEntryWords];
#pragma unroll
  for (int k = 0; k < kEntryWords; k++) acc[k] = 0;
#pragma unroll 4
  for (int e = 0; e < NENT; e++) {
    const uint32_t m = 0u - (uint32_t)(idx == e);
#ifdef __CUDA_ARCH__
    const uint4* row = reinterpret_cast<const uint4*>(tbl + e * kEntryWords);
#pragma unroll
    for (int q = 0; q < kEntryWords / 4; q++) {
      const uint4 v = row[q];
      acc[4 * q] |= v.x & m;
      acc[4 * q + 1] |= v.y & m;
      acc[4 * q + 2] |= v.z & m;
      acc[4 * q + 3] |= v.w & m;
    }
#else
    for (int k = 0; k < kEntryWords; k++) acc[k] |= tbl[e * kEntryWords + k] & m;
#endif
  }
  unpack_pa(ypx, ymx, t2d, acc);
}

// gather<NENT> over one packed table, as the gather policy of base_mult.
template <int NENT>
struct ScanGather {
  const uint32_t* tbl;
  FE_HD void operator()(Fe& ypx, Fe& ymx, Fe& t2d, int32_t idx) const {
    gather<NENT>(ypx, ymx, t2d, tbl, idx);
  }
};

// Folding base multiply S = a*G from NCUTS digits (32 for fold 8 over a
// 256-entry table, 64 for fold 4 over 16 entries): the randomized start
// (2xR : 2yR : 2R : 2xyR) from entry cut[0], then (NCUTS - 1) x (double +
// table add) (models/edwards._base_mult_folded). `cut` is read at indices
// that depend only on the step counter. `gather(ypx, ymx, t2d, digit)` reads
// a table entry in constant time: ScanGather, or basemult.cu's
// Limbs13Gather over the tensor-core gather (gather_mma.cuh).
template <int NCUTS, class Gather>
FE_HD Ext base_mult(const int32_t* cut, const Fe& zr, const Gather& gather) {
  Fe ypx, ymx, t2d;
  gather(ypx, ymx, t2d, cut[0]);
  const Fe x2 = sub(ypx, ymx);       // 2x
  const Fe y2 = add(ypx, ymx);       // 2y
  const Fe t2 = mul(t2d, ed_di());   // 2xy = t2d / d
  Ext s = {mul(x2, zr), mul(y2, zr), add(zr, zr), mul(t2, zr)};
#pragma unroll 1
  for (int i = 1; i < NCUTS; i++) {
    s = dbl(s);
    gather(ypx, ymx, t2d, cut[i]);
    s = add_pa(s, ypx, ymx, t2d);
  }
  return s;
}

FE_HD Fe one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = i == 0;
  return r;
}

}  // namespace ed25519
