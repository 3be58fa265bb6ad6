// verify_lane.cuh -- the per-lane code of Ed25519 verification on the
// 13-bit core, shared by poly.cu (the double-scalar multiply) and oneshot.cu
// (Verify_Init and the double-scalar multiply fused in one kernel), and the
// layout of the q_table's int8 planes, which verify.cu (Verify_Init on the
// wide core, fe25519_wide.cuh) writes too.
//
// Verify_Init (build_qtable): decode the 32 pk bytes (bit 255 is the parity,
// flipped for -Q; y >= p is taken mod p), decompress x with the sqrt ratio,
// then build the 16-entry q_table of subset sums of {-Q, 2^64(-Q),
// 2^128(-Q), 2^192(-Q)} in PE form with 192 doublings and 11 PE adds.
// The double-scalar multiply (poly_lane): R' = s*G + h*(-Q) from the 8-fold
// digits of s and the 4-fold digits of h, 31 x (double + PE add), 32 x
// (double + PA add + PE add), and enc(R').
//
// Both are templates over where the q_table lives (a policy with
// store(i, entry), prefetch(i), read(i, more) and add(p, i, more), which
// returns p + entry i; oneshot.cu's keeps int16 limbs in a scratch row).
// PlaneRows below reads the JAX context's int8 planes, [16, 160] per lane:
// per entry the 80 canonical limbs of (ypx, ymx, t2d, z2), first their low
// 7 bits (80 bytes), then their high 6 bits (80 bytes); a limb is
// lo + (hi << 7). Read as 32-bit words, an entry is 40 words and starts on
// a 16-byte boundary (store_limbs writes one coordinate). The entries are
// canonical, so they equal (mod p) the weak limbs the TPU kernel added, and
// every later result is the same field element. The base table of s is read
// through a policy too (PlainPa: the packed fold-8 table, load_pa).
//
// Table reads: verify works on public data (the signature, the key, the
// message), so both tables are read at an address that depends on the digit
// (ROADMAP ground rule "Constant time"; verify_kernel.py:16-17), where the
// masked scan that keygen and sign must use would cost ~254 K ALU operations
// per lane, about half again the loop's field arithmetic.

#pragma once

#include "edwards25519.cuh"

using namespace ed25519;

constexpr int kQtEntryWords = 40;              // 160 bytes per entry
constexpr int kQtWords = 16 * kQtEntryWords;   // one lane's q_table
constexpr int kTableWords = 256 * kEntryWords; // the packed fold-8 table

FE_HD Fe small(int32_t c) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = i == 0 ? c : 0;
  return r;
}

// Ext -> PE form (models/edwards.to_pe).
FE_HD Pe to_pe(const Ext& p) {
  return {add(p.y, p.x), sub(p.y, p.x), mul(p.t, ed_2d()), add(p.z, p.z)};
}

// Coordinate c of an entry from its 20 canonical limbs, split into the lo
// and hi planes (verify.cu's Verify_Init on the wide core converts to these
// limbs first, fe_wide::to_limbs13).
FE_HD void store_limbs(uint32_t* entry, int c, const int32_t (&limb)[NLIMBS]) {
#pragma unroll
  for (int k = 0; k < NLIMBS / 4; k++) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int b = 0; b < 4; b++) {
      const uint32_t l = (uint32_t)limb[4 * k + b];
      lo |= (l & 0x7F) << (8 * b);
      hi |= (l >> 7) << (8 * b);
    }
    entry[5 * c + k] = lo;
    entry[20 + 5 * c + k] = hi;
  }
}

// The 80 limbs (ypx, ymx, t2d, z2) as an entry.
FE_HD Pe pe_from_limbs(const int32_t (&limb)[4 * NLIMBS]) {
  Pe e;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    e.ypx.v[i] = limb[i];
    e.ymx.v[i] = limb[NLIMBS + i];
    e.t2d.v[i] = limb[2 * NLIMBS + i];
    e.z2.v[i] = limb[3 * NLIMBS + i];
  }
  return e;
}

// Limbs 4k..4k+3 of a coordinate from word k of its lo plane and word k of
// its hi plane: limb b = byte b of lo + (byte b of hi << 7).
FE_HD void decode_word(int32_t* limb, uint32_t lo, uint32_t hi) {
#pragma unroll
  for (int b = 0; b < 4; b++) {
#ifdef __CUDA_ARCH__
    limb[b] = (int32_t)(__byte_perm(lo, 0, 0x4440 + b) + (__byte_perm(hi, 0, 0x4440 + b) << 7));
#else
    limb[b] = (int32_t)(((lo >> (8 * b)) & 0xFF) + (((hi >> (8 * b)) & 0xFF) << 7));
#endif
  }
}

FE_HD Pe decode_planes(const uint32_t (&w)[kQtEntryWords]) {
  int32_t limb[4 * NLIMBS];
#pragma unroll
  for (int k = 0; k < 20; k++) decode_word(limb + 4 * k, w[k], w[20 + k]);
  return pe_from_limbs(limb);
}

FE_HD Pe load_entry(const uint32_t* entry) {
  uint32_t w[kQtEntryWords];
  load_words(w, entry);
  return decode_planes(w);
}

// An int8-plane entry read a coordinate at a time (add_pe_with): its 16-byte
// chunk q at entry + 4q words. Coordinate c's lo words 5c..5c+4 are words
// c..c+4 of chunks c and c+1, its hi words those of chunks c+5 and c+6.
struct PlaneCoord {
  const uint32_t* entry;

  template <int C>
  FE_HD Fe coord() const {
    uint32_t lo[2][4], hi[2][4];
    load_words(lo[0], entry + 4 * C);
    load_words(lo[1], entry + 4 * (C + 1));
    load_words(hi[0], entry + 4 * (C + 5));
    load_words(hi[1], entry + 4 * (C + 6));
    Fe r;
#pragma unroll
    for (int k = 0; k < NLIMBS / 4; k++)
      decode_word(r.v + 4 * k, lo[(C + k) >> 2][(C + k) & 3], hi[(C + k) >> 2][(C + k) & 3]);
    return r;
  }
};

// A q_table of int8 planes at qt, read where the double-scalar multiply
// uses it (poly_kernel: the lane's table in device memory;
// poly_shared_kernel: one table in shared memory): its first entry whole,
// then a coordinate at a time.
struct PlaneRows {
  uint32_t* qt;
  FE_HD void prefetch(int) {}
  FE_HD Pe read(int i, bool) { return load_entry(qt + i * kQtEntryWords); }
  FE_HD Ext add(const Ext& p, int i, bool) {
    return add_pe_with(p, PlaneCoord{qt + i * kQtEntryWords});
  }
};

// The packed fold-8 table, read by index (load_pa).
struct PlainPa {
  const uint32_t* tbl;
  FE_HD void operator()(Fe& ypx, Fe& ymx, Fe& t2d, int32_t idx) const {
    load_pa(ypx, ymx, t2d, tbl, idx);
  }
};

// x from y with the given parity, and ok = 1 where (y^2 - 1)/(d y^2 + 1) is a
// square (models/edwards.calculate_x).
FE_HD Fe calculate_x(const Fe& y, int32_t parity, int32_t& ok) {
  const Fe y2 = sqr(y);
  const Fe u = sub(y2, one());
  const Fe v = add(mul(y2, ed_d()), one());
  const Fe x = sqrt_ratio(u, v, ok);
  const Fe xc = canon(x);
  return select((xc.v[0] ^ parity) & 1, neg(xc), xc);
}

// Verify_Init of one lane: stores the 16 q_table entries of -Q in qt and
// returns ok (ops/cuda/verify_kernel.verify_init_plain). Entry s of the
// subset-sum adds is requested (qt.prefetch) one add ahead of its use, entry
// 1 before the doublings.
template <class Q>
FE_HD int32_t build_qtable(Q& qt, const uint8_t* pk) {
  int32_t b[32];
#pragma unroll
  for (int j = 0; j < 32; j++) b[j] = pk[j];
  const int32_t parity = 1 - ((b[31] >> 7) & 1);  // the parity of -Q
  b[31] &= 0x7F;
  const Fe y = from_bytes(b);
  int32_t ok;
  const Fe x = calculate_x(y, parity, ok);
  Ext q = {x, y, one(), mul(x, y)};
  qt.store(0, {small(1), small(1), small(0), small(2)});  // the identity
  qt.store(1, to_pe(q));
#pragma unroll 1
  for (int base = 2; base < 16; base *= 2) {
    qt.prefetch(1);
#pragma unroll 1
    for (int i = 0; i < 64; i++) q = dbl(q);
    qt.store(base, to_pe(q));
#pragma unroll 1
    for (int s = 1; s < base; s++) {
      if (s + 1 < base) qt.prefetch(s + 1);
      qt.store(base + s, to_pe(add_pe(q, qt.read(s, s + 1 < base))));
    }
  }
  return ok;
}

// enc(s*G + h*(-Q)) of one lane (ops/cuda/verify_kernel.poly_mult_plain).
// u: the 32 8-fold digits of s; v: the 64 4-fold digits of h; qt: the lane's
// q_table (its entries are read in the order v[0], ..., v[63], each requested
// one step ahead); pa: the fold-8 table. Digits are read mod 256 and 16.
// Steps: 31 x (double + PE add of v[i]), then 32 x (double + PA add of u[i]
// + PE add of v[32 + i]), as one rolled loop whose PA add sits under a
// warp-uniform branch, so the code of a double and a PE add appears once.
template <class Q, class PA>
FE_HD void poly_lane(uint8_t* out, const int32_t* u, const int32_t* v, Q& qt, const PA& pa) {
  qt.prefetch(v[0] & 15);
  qt.prefetch(v[1] & 15);
  const Pe q0 = qt.read(v[0] & 15, true);
  Ext s = {sub(q0.ypx, q0.ymx), add(q0.ypx, q0.ymx), q0.z2, mul(q0.t2d, ed_di())};
#pragma unroll 1
  for (int i = 1; i < 64; i++) {
    s = dbl(s);
    if (i >= 32) {
      Fe ypx, ymx, t2d;
      pa(ypx, ymx, t2d, u[i - 32] & 255);
      s = add_pa(s, ypx, ymx, t2d);
    }
    if (i < 63) qt.prefetch(v[i + 1] & 15);
    s = qt.add(s, v[i] & 15, i < 63);
  }
  int32_t enc[32];
  pack_ext(enc, s);
#pragma unroll
  for (int j = 0; j < 32; j++) out[j] = (uint8_t)enc[j];
}
