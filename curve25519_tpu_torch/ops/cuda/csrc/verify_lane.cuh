// verify_lane.cuh -- the per-lane code of Ed25519 verification on the wide
// field core (fe25519_wide.cuh, ten 32-bit limbs in radix 2^25.5) through
// the point formulas of edwards25519_wide.cuh, and the layout of the
// q_table's int8 planes. Shared by verify.cu (Verify_Init), poly.cu (the
// double-scalar multiply) and oneshot.cu (the two in one kernel).
//
// Verify_Init (verify_init_lane): decode the 32 pk bytes (bit 255 is the
// parity, flipped for -Q; y >= p is taken mod p), decompress x with the
// sqrt ratio, then build the 16-entry q_table of subset sums of {-Q,
// 2^64(-Q), 2^128(-Q), 2^192(-Q)} in PE form with 192 doublings and 11 PE
// adds, each entry stored in the planes as soon as it is made.
// The double-scalar multiply (poly_lane): R' = s*G + h*(-Q) from the 8-fold
// digits of s and the 4-fold digits of h, 31 x (double + PE add), 32 x
// (double + PA add + PE add), and enc(R').
//
// The planes, [16, 160] bytes per lane (the JAX context's layout,
// models/tables.pe_planes_from_canonical): per entry the 80 canonical 13-bit
// limbs of (ypx, ymx, t2d, z2), first their low 7 bits (80 bytes), then
// their high 6 bits (80 bytes); a limb is lo + (hi << 7). Read as 32-bit
// words an entry is 40 words and starts on a 16-byte boundary. The 13-bit
// radix lives only here, where an entry is stored (store_wide) or read
// (PlaneEntry); the lanes compute on wide limbs. The plain versions run the
// same formulas in the same order on the 13-bit radix, so every point is
// the same field elements with other limbs: the canonical entries and the
// encoded R' come out byte for byte, for keys off the curve too.
//
// Table reads: verify works on public data (the signature, the key, the
// message), so both tables are read at an address that depends on the digit
// (ROADMAP ground rule "Constant time"; verify_kernel.py:16-17), where a
// masked scan would cost more ALU work than the loop's field arithmetic.
// The base table of s is edwards_kernel.word_table(8): per entry ypx, ymx
// and t2d, each the 8 little-endian 32-bit words of its canonical value.
//
// The limb bounds of both lanes are proven by `_check_wide_core_bounds` in
// tests/test_torch_ladder_host.py (`_check_wide_edwards_bounds`,
// `_check_wide_poly_bounds`).

#pragma once

#include "edwards25519_wide.cuh"

constexpr int kQtEntryWords = 40;              // 160 bytes per entry
constexpr int kQtWords = 16 * kQtEntryWords;   // one lane's q_table
constexpr int kBaseEntryWords = 24;            // a word-table entry
constexpr int kBaseWords = 256 * kBaseEntryWords;  // the fold-8 word table

// Reads N words from a 16-byte aligned address (16-byte loads on the
// device).
template <int N>
FE_HD void load_words(uint32_t (&w)[N], const uint32_t* src) {
#ifdef __CUDA_ARCH__
  const uint4* row = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < N / 4; q++) {
    const uint4 v = row[q];
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
#else
  for (int k = 0; k < N; k++) w[k] = src[k];
#endif
}

// Coordinate c of an entry from its 20 canonical limbs, split into the lo
// and hi planes.
FE_HD void store_limbs(uint32_t* entry, int c, const int32_t (&limb)[fe_wide::kLimbs13]) {
#pragma unroll
  for (int k = 0; k < fe_wide::kLimbs13 / 4; k++) {
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

// Coordinate c of an entry from a wide element: canonical, as twenty 13-bit
// limbs, split into the lo and hi planes.
FE_HD void store_wide(uint32_t* entry, int c, const fe_wide::Fe& x) {
  int32_t limb[fe_wide::kLimbs13];
  fe_wide::to_limbs13(limb, fe_wide::canon(x));
  store_limbs(entry, c, limb);
}

FE_HD void store_pe(uint32_t* entry, const ed_wide::Pe& e) {
  store_wide(entry, 0, e.ypx);
  store_wide(entry, 1, e.ymx);
  store_wide(entry, 2, e.t2d);
  store_wide(entry, 3, e.z2);
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

// A stored entry read a coordinate at a time (ed_wide::add_pe's Q): the
// coordinate's canonical 13-bit limbs from the planes, as TIGHT wide limbs.
// Its 16-byte chunk q is at entry + 4q words: coordinate C's lo words
// 5C..5C+4 are words C..C+4 of chunks C and C+1, its hi words those of
// chunks C+5 and C+6.
struct PlaneEntry {
  const uint32_t* entry;

  template <int C>
  FE_HD fe_wide::Fe coord() const {
    uint32_t lo[2][4], hi[2][4];
    load_words(lo[0], entry + 4 * C);
    load_words(lo[1], entry + 4 * (C + 1));
    load_words(hi[0], entry + 4 * (C + 5));
    load_words(hi[1], entry + 4 * (C + 6));
    int32_t limb[fe_wide::kLimbs13];
#pragma unroll
    for (int k = 0; k < fe_wide::kLimbs13 / 4; k++)
      decode_word(limb + 4 * k, lo[(C + k) >> 2][(C + k) & 3], hi[(C + k) >> 2][(C + k) & 3]);
    return fe_wide::from_limbs13(limb);
  }
};

// A stored entry as ed_wide::add_pe's P: Y+X and Y-X as stored, T and Z
// from the stored 2dT and 2Z by a constant multiply each.
struct BaseEntry {
  const uint32_t* entry;

  template <int C>
  FE_HD fe_wide::Fe coord() const {
    const fe_wide::Fe c = PlaneEntry{entry}.coord<C>();
    if constexpr (C == 2) return fe_wide::mul(c, ed_wide::inv_2d());
    if constexpr (C == 3) return fe_wide::mul(c, ed_wide::inv_2());
    return c;
  }
};

// Verify_Init of one lane: stores the 16 q_table entries of -Q in the
// planes at qt and the decode's flag in *ok
// (ops/cuda/verify_kernel.verify_init_plain). The 192 doublings come first,
// storing entries 1, 2, 4 and 8; then entry e = base + s (base the power
// of 2 below e) = entry base + entry s, both read back from the planes. Q is
// dead by then, so only pointers stay live across the adds.
FE_HD void verify_init_lane(uint32_t* qt, uint8_t* ok, const uint8_t* pk) {
  const uint32_t parity = 1 - (pk[31] >> 7);       // the parity of -Q
  const fe_wide::Fe y = fe_wide::from_bytes(pk);   // bit 255 is not read
  uint32_t decoded;
  const fe_wide::Fe x = ed_wide::calculate_x(y, parity, decoded);
  *ok = (uint8_t)decoded;
  ed_wide::Ext q = {x, y, fe_wide::one(), fe_wide::mul(x, y)};
  const fe_wide::Fe one = fe_wide::one();
  store_pe(qt, {one, one, fe_wide::Fe{}, fe_wide::add(one, one)});  // the identity
  store_pe(qt + kQtEntryWords, ed_wide::to_pe(q));
#pragma unroll 1
  for (int k = 1; k < 4; k++) {
#pragma unroll 1
    for (int i = 0; i < 64; i++) q = ed_wide::dbl(q);
    store_pe(qt + (kQtEntryWords << k), ed_wide::to_pe(q));
  }
#pragma unroll 1
  for (int e = 3; e < 16; e++) {
    const int base = e >= 8 ? 8 : e >= 4 ? 4 : 2;
    if (e == base) continue;                       // entries 4 and 8: made above
    store_pe(qt + e * kQtEntryWords,
             ed_wide::to_pe(ed_wide::add_pe(BaseEntry{qt + base * kQtEntryWords},
                                            PlaneEntry{qt + (e - base) * kQtEntryWords})));
  }
}

// Entry idx of the word table at tbl (16-byte aligned), read by index: its
// canonical coordinates as TIGHT limbs.
FE_HD void load_base(fe_wide::Fe& ypx, fe_wide::Fe& ymx, fe_wide::Fe& t2d, const uint32_t* tbl,
                     int32_t idx) {
  const uint32_t* entry = tbl + idx * kBaseEntryWords;
  uint32_t w[8];
  load_words(w, entry);
  ypx = fe_wide::from_words(w);
  load_words(w, entry + 8);
  ymx = fe_wide::from_words(w);
  load_words(w, entry + 16);
  t2d = fe_wide::from_words(w);
}

// enc(s*G + h*(-Q)) of one lane (ops/cuda/verify_kernel.poly_mult_plain).
// u: the 32 8-fold digits of s; v: the 64 4-fold digits of h; qt: the
// lane's q_table planes (16-byte aligned; device or shared memory); tbl: the
// fold-8 word table. Digits are read mod 256 and 16. The start is entry
// v[0] as (Y+X - (Y-X), Y+X + (Y-X), 2Z, 2dT / d) = 2(X : Y : Z : T); its X
// and Y are sums of canonical limbs, carried to TIGHT for dbl. Then 31 x
// (double + PE add of v[i]), then 32 x (double + PA add of u[i] + PE add of
// v[32 + i]), as one rolled loop whose PA add sits under a warp-uniform
// branch, so the code of a double and a PE add appears once. Each entry is
// read a coordinate at a time, just before the multiply that takes it.
FE_HD void poly_lane(uint8_t* out, const int32_t* u, const int32_t* v, const uint32_t* qt,
                     const uint32_t* tbl) {
  using namespace ed_wide;
  const PlaneEntry q0{qt + (v[0] & 15) * kQtEntryWords};
  const Fe ypx = q0.coord<0>(), ymx = q0.coord<1>();
  Ext s = {weak_carry(sub(ypx, ymx)), weak_carry(add(ypx, ymx)), q0.coord<3>(),
           mul(q0.coord<2>(), ed_di())};
#pragma unroll 1
  for (int i = 1; i < 64; i++) {
    s = dbl(s);
    if (i >= 32) {
      Fe bypx, bymx, bt2d;
      load_base(bypx, bymx, bt2d, tbl, u[i - 32] & 255);
      s = add_pa(s, bypx, bymx, bt2d);
    }
    s = add_pe(ExtReader{s}, PlaneEntry{qt + (v[i] & 15) * kQtEntryWords});
  }
  pack(out, s);
}
