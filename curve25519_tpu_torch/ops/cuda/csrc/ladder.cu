// ladder.cu -- X25519 scalar multiply, one lane per thread (CUDA, sm_90a).
//
// Replaces the TPU kernel curve25519_tpu/ops/pallas/ladder_kernel.py
// `_ladder_kernel` (launched by `ladder_tiled`, wrapped by
// `point_multiply_pallas`). It computes the same thing, step for step, in
// another radix:
//   - decode the peer's u from its 32 bytes with bit 255 masked; a
//     non-canonical u (>= p) is decoded unreduced;
//   - start from P = (u*zr : zr), Q = 2P (zr = 1 when no zr is given);
//   - 254 ladder steps over key bits 253..0 with a deferred swap on
//     bit ^ prev, then a final select on prev;
//   - invert Z, multiply, canonicalize and write 32 bytes.
// Where the TPU kernel padded the batch to whole 1024-lane tiles, each thread
// here owns one lane and the grid masks the ragged end (lane < n).
//
// Constant time: the swap is mask arithmetic on the key bit, the key byte
// read in each step is indexed by the public loop counter only, the loop
// always runs 254 steps, and no branch or index of the field core depends
// on a limb value.
//
// What bounds it on this card: the two exact multipliers. A lane performs
// about 2,556 field multiplies and squarings (254 x (5M + 4S + 1 small) for
// the ladder, 254 S + 11 M for the inversion, a few for the start), and
// nothing is shared between lanes. An `IMAD.WIDE.U32` (32x32->64, the FMA
// pipe) issues at about 31 per clock per SM, half the rate of a 32-bit
// IMAD; a `DFMA` (fma.rn.f64, the FP64 pipe, otherwise idle here) at 64,
// and its product of two balanced limbs of radix 2^25.5 is exact. The bound
// in portbench/bound.py lets both pipes run at once. What the design does
// about it: each step splits its work over both pipes. Three of the five
// multiplies, c * (x2 - z2), aa * bb and u * (da - cb)^2, run on
// fe25519_f64.cuh: the limbs carried to balanced doubles, 100 exact DFMAs
// into 19 columns and carries by rounding adds, all on the FP64 pipe, and
// back as fe_wide limbs (u's doubles are made once, before the loop). The
// other two, the four squarings and the a24 multiply-add run on
// fe25519_wide.cuh, ten 32-bit limbs in radix 2^25.5 whose products are
// single `IMAD.WIDE.U32`s summed into 64-bit columns (100 per multiply, 55
// per squaring, 10 per a24 multiply-add), its operands kept 32-bit
// (fe_wide::operand), so no product pays a second IMAD for a high word.
// The split is the one that measured fastest: the FP64 pipe's work beside
// IMAD.WIDE is not free (the two overlap in part), and its moves and
// carries cost as much as the 55 products of a squaring, so only a
// multiply's 100 products pay for them; moving more than three multiplies
// loads the FP64 pipe more than it unloads the FMA pipe. The inversion
// stays on the integer core: it has nothing to overlap with.
// x25519_ladder_products gives the limb products a lane issues on each
// pipe. The state is five 10-limb elements; 128 threads a block, at most
// 168 registers so that three blocks fit an SM. zr arrives in the 13-bit
// radix: it is canonicalized with fe25519 once per lane and decoded in the
// new radix; the output depends only on zr's value mod p.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (x25519_ladder_launch), and with g++ for the CPU
// tests (x25519_ladder_host, fe_wide_op_host, and fe25519_op_host for the
// 13-bit core that the other kernels share), which run the same per-lane
// code on the host.

#include "fe25519_f64.cuh"
#include "weak_limbs.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

// Ladder steps after the start's virtual step for bit 254: bits 253..0.
constexpr int kSteps = 254;

// One lane: out = x-coordinate bytes of clamp(key) * u. `key` must already
// be clamped (bit 254 set). `zr` is 20 signed-weak limbs, or null for one.
FE_HD void x25519_lane(uint8_t* out, const uint8_t* ubytes, const uint8_t* key,
                       const int32_t* zr_limbs) {
  using namespace fe_wide;
  const Fe u = from_bytes(ubytes);        // bit 255 is not read (RFC 7748)
  const Fe zr = zr_limbs ? wide_from_weak_limbs(zr_limbs) : one();

  // State after the virtual step for bit 254: A = 2P (doubled side),
  // B = P (sum side), prev = 1; the logical low point is prev ? B : A.
  Fe bx = mul(u, zr);
  Fe bz = zr;
  Fe ax, az;
  {
    const Fe aa = sqr(add(bx, bz));
    const Fe bb = sqr(sub(bx, bz));
    ax = mul(aa, bb);
    const Fe e = sub(aa, bb);
    az = mul(e, mul_small_add(aa, A24, e));
  }
  uint32_t prev = (key[31] >> 6) & 1;

#pragma unroll 1
  for (int i = kSteps - 1; i >= 0; i--) {
    const uint32_t bit = (key[i >> 3] >> (i & 7)) & 1;
    const uint32_t s = bit ^ prev;
    const Fe x2 = select(s, bx, ax);
    const Fe x3 = select(s, ax, bx);
    const Fe z2 = select(s, bz, az);
    const Fe z3 = select(s, az, bz);

    const Fe a = add(x2, z2);
    const Fe bm = sub(x2, z2);
    const Fe c = add(x3, z3);
    const Fe d = sub(x3, z3);
    const Fe aa = sqr(a);
    const Fe bb = sqr(bm);
    const Fe da = mul(d, a);
    const Fe cb = fe_f64::mul(c, bm);
    ax = fe_f64::mul(aa, bb);
    const Fe e = sub(aa, bb);
    az = mul(e, mul_small_add(aa, A24, e));
    bx = sqr(add(da, cb));
    bz = fe_f64::mul(u, sqr(sub(da, cb)));
    prev = bit;
  }
  const Fe lo_x = select(prev, bx, ax);
  const Fe lo_z = select(prev, bz, az);
  to_bytes(out, mul(lo_x, inv(lo_z)));
}

#ifdef __CUDACC__

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock, 3)
x25519_ladder_kernel(uint8_t* __restrict__ out, const uint8_t* __restrict__ u,
                     const uint8_t* __restrict__ k, const int32_t* __restrict__ zr,
                     int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  x25519_lane(out + 32 * lane, u + 32 * lane, k + 32 * lane,
              zr ? zr + fe25519::NLIMBS * lane : nullptr);
}

// out, u, k: [n, 32] uint8, contiguous, on the device; zr: [n, 20] int32 or
// null. Launches on `stream`, allocates nothing, does not synchronize.
// Returns cudaGetLastError() (0 on success).
extern "C" int x25519_ladder_launch(void* out, const void* u, const void* k,
                                    const void* zr, int64_t n, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kBlock - 1) / kBlock;
    x25519_ladder_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
        (uint8_t*)out, (const uint8_t*)u, (const uint8_t*)k, (const int32_t*)zr, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// The limb products one lane issues: out[0] on the FP64 pipe (three
// multiplies a step), out[1] on the integer pipe (the other multiplies, 523
// with the start's 3, the last one and the inversion's 11; the 1,272
// squarings, 4 a step, 2 at the start and 254 in the inversion; 255 a24
// multiply-adds). Returns 0.
extern "C" int x25519_ladder_products(int64_t* out) {
  constexpr int64_t kMul = fe_f64::kMulProducts;    // fe_wide::mul's too
  constexpr int64_t kSqr = fe_wide::NLIMBS * (fe_wide::NLIMBS + 1) / 2;
  constexpr int64_t kSmall = fe_wide::NLIMBS;
  out[0] = 3 * kSteps * kMul;
  out[1] = (3 + 2 * kSteps + 1 + 11) * kMul + (2 + 4 * kSteps + 254) * kSqr +
           (1 + kSteps) * kSmall;
  return 0;
}

// ---------------------------------------------------------------------------
// Host entries: the same per-lane code on the CPU, for the tests.
// ---------------------------------------------------------------------------
extern "C" void x25519_ladder_host(uint8_t* out, const uint8_t* u, const uint8_t* k,
                                   const int32_t* zr, int64_t n) {
  for (int64_t i = 0; i < n; i++)
    x25519_lane(out + 32 * i, u + 32 * i, k + 32 * i,
                zr ? zr + fe25519::NLIMBS * i : nullptr);
}

enum FeOp {
  FE_ADD, FE_SUB, FE_NEG, FE_MUL, FE_SQR, FE_MUL_SMALL_ADD, FE_CANON, FE_INV,
  FE_TO_BYTES, FE_FROM_BYTES
};

// One op of the 13-bit core over n lanes. x, y, out: [n, 20] int32 limbs, except that
// FE_TO_BYTES writes and FE_FROM_BYTES reads [n, 32] int32 byte values.
// FE_MUL_SMALL_ADD computes x + A24 * y. Returns 0, or -1 for an unknown op.
extern "C" int fe25519_op_host(int op, int32_t* out, const int32_t* x,
                               const int32_t* y, int64_t n) {
  using namespace fe25519;
  for (int64_t lane = 0; lane < n; lane++) {
    Fe a, b, r;
    if (op == FE_FROM_BYTES) {
      int32_t bytes[32];
      for (int j = 0; j < 32; j++) bytes[j] = x[32 * lane + j];
      r = from_bytes(bytes);
    } else {
      for (int i = 0; i < NLIMBS; i++) {
        a.v[i] = x[NLIMBS * lane + i];
        b.v[i] = y ? y[NLIMBS * lane + i] : 0;
      }
      switch (op) {
        case FE_ADD: r = add(a, b); break;
        case FE_SUB: r = sub(a, b); break;
        case FE_NEG: r = neg(a); break;
        case FE_MUL: r = mul(a, b); break;
        case FE_SQR: r = sqr(a); break;
        case FE_MUL_SMALL_ADD: r = mul_small_add(a, A24, b); break;
        case FE_CANON: r = canon(a); break;
        case FE_INV: r = inv(a); break;
        case FE_TO_BYTES: {
          int32_t enc[32];
          to_bytes(enc, a);
          for (int j = 0; j < 32; j++) out[32 * lane + j] = enc[j];
          continue;
        }
        default: return -1;
      }
    }
    for (int i = 0; i < NLIMBS; i++) out[NLIMBS * lane + i] = r.v[i];
  }
  return 0;
}

enum WideOp {
  WIDE_ADD, WIDE_SUB, WIDE_MUL, WIDE_SQR, WIDE_MUL_SMALL_ADD, WIDE_SELECT,
  WIDE_CANON, WIDE_INV, WIDE_TO_BYTES, WIDE_FROM_BYTES, WIDE_NEG,
  WIDE_WEAK_CARRY, WIDE_POW2523, WIDE_IS_ZERO, WIDE_SQRT_RATIO,
  WIDE_TO_LIMBS13, WIDE_FROM_LIMBS13, WIDE_MUL_F64, WIDE_TO_F64, WIDE_FROM_F64
};

// One op of the wide core (fe25519_wide.cuh) over n lanes. x, y, out:
// [n, 10] uint32 limbs, except that WIDE_TO_BYTES writes and
// WIDE_FROM_BYTES reads [n, 32] bytes, WIDE_TO_LIMBS13 writes and
// WIDE_FROM_LIMBS13 reads [n, 20] int32 13-bit limbs, WIDE_IS_ZERO writes
// [n, 1] and WIDE_SQRT_RATIO [n, 11] (sqrt_ratio(x, y)'s limbs, then ok).
// The FP64 multiply of fe25519_f64.cuh and its moves: WIDE_MUL_F64 is
// fe_f64::mul, WIDE_TO_F64 writes [n, 20] doubles (to_balanced's y, then
// 2y) and WIDE_FROM_F64 reads [n, 10] doubles, each 2^52 + a limb.
// WIDE_MUL_SMALL_ADD computes x + A24 * y; WIDE_SELECT gives x on odd lanes
// and y on even ones. Returns 0, or -1 for an unknown op.
extern "C" int fe_wide_op_host(int op, void* out, const void* x,
                               const void* y, int64_t n) {
  using namespace fe_wide;
  uint32_t* limbs_out = (uint32_t*)out;
  const uint32_t* xl = (const uint32_t*)x;
  const uint32_t* yl = (const uint32_t*)y;
  for (int64_t lane = 0; lane < n; lane++) {
    Fe a, b, r;
    if (op == WIDE_FROM_BYTES) {
      r = from_bytes((const uint8_t*)x + 32 * lane);
    } else if (op == WIDE_FROM_F64) {
      double held[NLIMBS];
      for (int i = 0; i < NLIMBS; i++) held[i] = ((const double*)x)[NLIMBS * lane + i];
      r = fe_f64::limbs_of(held);
    } else if (op == WIDE_FROM_LIMBS13) {
      int32_t limb[kLimbs13];
      for (int k = 0; k < kLimbs13; k++) limb[k] = ((const int32_t*)x)[kLimbs13 * lane + k];
      r = from_limbs13(limb);
    } else {
      for (int i = 0; i < NLIMBS; i++) {
        a.v[i] = xl[NLIMBS * lane + i];
        b.v[i] = yl ? yl[NLIMBS * lane + i] : 0;
      }
      switch (op) {
        case WIDE_ADD: r = add(a, b); break;
        case WIDE_SUB: r = sub(a, b); break;
        case WIDE_MUL: r = mul(a, b); break;
        case WIDE_SQR: r = sqr(a); break;
        case WIDE_MUL_F64: r = fe_f64::mul(a, b); break;
        case WIDE_TO_F64: {
          double* y = (double*)out + 2 * NLIMBS * lane;
          double yb[NLIMBS], y2[NLIMBS];
          fe_f64::to_balanced(yb, y2, a);
          for (int i = 0; i < NLIMBS; i++) {
            y[i] = yb[i];
            y[NLIMBS + i] = y2[i];
          }
          continue;
        }
        case WIDE_MUL_SMALL_ADD: r = mul_small_add(a, A24, b); break;
        case WIDE_SELECT: r = select((uint32_t)(lane & 1), a, b); break;
        case WIDE_CANON: r = canon(a); break;
        case WIDE_INV: r = inv(a); break;
        case WIDE_NEG: r = neg(a); break;
        case WIDE_WEAK_CARRY: r = weak_carry(a); break;
        case WIDE_POW2523: r = pow2523(a); break;
        case WIDE_TO_BYTES:
          to_bytes((uint8_t*)out + 32 * lane, a);
          continue;
        case WIDE_IS_ZERO:
          limbs_out[lane] = is_zero(a);
          continue;
        case WIDE_SQRT_RATIO: {
          uint32_t ok;
          r = sqrt_ratio(a, b, ok);
          for (int i = 0; i < NLIMBS; i++) limbs_out[11 * lane + i] = r.v[i];
          limbs_out[11 * lane + NLIMBS] = ok;
          continue;
        }
        case WIDE_TO_LIMBS13: {
          int32_t limb[kLimbs13];
          to_limbs13(limb, a);
          for (int k = 0; k < kLimbs13; k++) ((int32_t*)out)[kLimbs13 * lane + k] = limb[k];
          continue;
        }
        default: return -1;
      }
    }
    for (int i = 0; i < NLIMBS; i++) limbs_out[NLIMBS * lane + i] = r.v[i];
  }
  return 0;
}
