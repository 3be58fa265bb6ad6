// fold_wide.cuh -- the folding base multiply for one lane on the wide field
// core (fe25519_wide.cuh) through the point formulas of
// edwards25519_wide.cuh: the lane of basemult_fold4_kernel (fold 4's byte
// modes), basemult_fold8_kernel (fold 8's byte modes), keygen_kernel and
// sign_kernel (csrc/basemult.cu, csrc/sign.cu).
//
// The plain version (models/edwards.base_point_mult and
// base_point_mult_fold4, the epilogues of ops/cuda/edwards_kernel.
// base_mult_plain) runs on 13-bit limbs; this lane runs its formulas in its
// order on another radix, so every intermediate point is the same point with
// other limbs, and the bytes, which depend only on the point, are equal.
// A table entry arrives as its words: ypx, ymx and t2d, each the 8
// little-endian 32-bit words of its canonical value
// (edwards_kernel.word_table). Fold 4 reads its 16 entries by a masked scan
// (ScanWords); fold 8 by the tensor cores' one-hot product
// (gather_mma::Gather), or on the host by its emulation or the scan. The
// interval proof of the lane's limb bounds is `_check_wide_fold_bounds` in
// tests/test_torch_ladder_host.py.
//
// Its names live in namespace fold_wide and take fe_wide's and ed_wide's by
// using-declarations: basemult.cu and sign.cu see the 13-bit core's names at
// global scope.

#pragma once

#include "edwards25519_wide.cuh"
#include "weak_limbs.cuh"

namespace fold_wide {

using ed_wide::add_pa;
using ed_wide::dbl;
using ed_wide::Ext;
using fe_wide::add;
using fe_wide::Fe;
using fe_wide::from_words;
using fe_wide::inv;
using fe_wide::mul;
using fe_wide::sub;
using fe_wide::to_bytes;

constexpr int kWords = 24;  // an entry: ypx, ymx, t2d, 8 words each

// The scan's loop takes two entries a trip (PERF.md section 6 lists 1, 2
// and 4 as tried). A fully unrolled scan reads the same 384 table words in
// every step, so nvcc hoists the reads out of the step loop and keeps them
// live: 972 B spilled even at 255 registers.

// Constant-time fetch of entry idx of a word table of NENT entries (16-byte
// aligned; 16-byte reads on the device): every entry is read, in the same
// order, and kept under a mask.
template <int NENT>
struct ScanWords {
  const uint32_t* tbl;

  FE_HD void operator()(uint32_t (&acc)[3][8], int32_t idx) const {
#pragma unroll
    for (int c = 0; c < 3; c++)
#pragma unroll
      for (int k = 0; k < 8; k++) acc[c][k] = 0;
#pragma unroll 2
    for (int e = 0; e < NENT; e++) {
      const uint32_t m = 0u - (uint32_t)(idx == e);
#pragma unroll
      for (int c = 0; c < 3; c++) {
#ifdef __CUDA_ARCH__
        const uint4* row = reinterpret_cast<const uint4*>(tbl + e * kWords + 8 * c);
#pragma unroll
        for (int q = 0; q < 2; q++) {
          const uint4 v = row[q];
          acc[c][4 * q] |= v.x & m;
          acc[c][4 * q + 1] |= v.y & m;
          acc[c][4 * q + 2] |= v.z & m;
          acc[c][4 * q + 3] |= v.w & m;
        }
#else
        for (int k = 0; k < 8; k++) acc[c][k] |= tbl[e * kWords + 8 * c + k] & m;
#endif
      }
    }
  }
};

// Entry idx from a words source (ScanWords, gather_mma::Gather or
// gather_mma::HostGather) as TIGHT limbs: canonical digits.
template <class Words>
FE_HD void gather(Fe& ypx, Fe& ymx, Fe& t2d, const Words& words, int32_t idx) {
  uint32_t w[3][8];
  words(w, idx);
  ypx = from_words(w[0]);
  ymx = from_words(w[1]);
  t2d = from_words(w[2]);
}

// The 8-fold digits of a scalar held as its 8 little-endian words: digit c
// takes bit 31 - c of word j as its bit j (ops/fold.cut8, the TPU's
// sc_tile.cut8_rows), computed when the step loop reads it, so that no
// per-lane array is indexed by the step counter (it would live in local
// memory).
struct CombDigits {
  uint32_t w[8];

  FE_HD int32_t operator[](int c) const {
    int32_t d = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) d |= (int32_t)((w[j] >> (31 - c)) & 1) << j;
    return d;
  }
};

// BP's 80 signed-weak 13-bit limbs (ypx, ymx, t2d, z2) as add_pe's Q, a
// coordinate converted when it is read.
struct WeakPeReader {
  const int32_t* bp;

  template <int C>
  FE_HD Fe coord() const {
    return wide_from_weak_limbs(bp + C * fe25519::NLIMBS);
  }
};

// S = a*G + BP: the plain version's ops in its order, the start
// (2xR : 2yR : 2R : 2xyR) from entry cut[0], (NCUTS - 1) x (dbl, gather,
// add_pa), the BP add. cut: NCUTS digits (a pointer, or CombDigits), read at
// the step counter only; zr: 20 limbs or null for one; bp: 80 limbs or null.
template <int NCUTS, class Digits, class Words>
FE_HD Ext base_mult(const Digits& cut, const int32_t* zr, const int32_t* bp,
                    const Words& words) {
  const Fe z0 = zr ? wide_from_weak_limbs(zr) : fe_wide::one();
  Fe ypx, ymx, t2d;
  gather(ypx, ymx, t2d, words, cut[0]);
  const Fe t2 = mul(t2d, ed_wide::ed_di());
  Ext s = {mul(sub(ypx, ymx), z0), mul(add(ypx, ymx), z0), add(z0, z0), mul(t2, z0)};
#pragma unroll 1
  for (int i = 1; i < NCUTS; i++) {
    s = dbl(s);
    gather(ypx, ymx, t2d, words, cut[i]);
    s = add_pa(s, ypx, ymx, t2d);
  }
  if (bp) s = ed_wide::add_pe(ed_wide::ExtReader{s}, WeakPeReader{bp});
  return s;
}

// The byte modes' epilogue, one inversion: of Z for pk (enc(S)), of Z - Y
// for u_bytes (enc(u), 0 for the identity, whose u is 0). out: 32 bytes.
FE_HD void epilogue(uint8_t* out, const Ext& s, bool pk) {
  if (pk) {
    ed_wide::pack(out, s);
  } else {
    to_bytes(out, mul(add(s.z, s.y), inv(sub(s.z, s.y))));
  }
}

// enc(S) as 8 little-endian words: ed_wide::pack's bytes.
FE_HD void pack_words(uint32_t (&w)[8], const Ext& s) {
  const Fe zi = inv(s.z);
  fe_wide::to_words(w, fe_wide::canon(mul(s.y, zi)));
  w[7] |= (fe_wide::canon(mul(s.x, zi)).v[0] & 1) << 31;
}

// One lane of the byte modes (basemult_fold4_kernel's).
template <int NCUTS, class Words>
FE_HD void lane(uint8_t* out, const int32_t* cut, const int32_t* zr, const int32_t* bp,
                bool pk, const Words& words) {
  epilogue(out, base_mult<NCUTS>(cut, zr, bp, words), pk);
}

}  // namespace fold_wide
