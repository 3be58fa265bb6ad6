// ladder.cu -- X25519 scalar multiply, one lane per thread (CUDA, sm_90a).
//
// Replaces the TPU kernel curve25519_tpu/ops/pallas/ladder_kernel.py
// `_ladder_kernel` (launched by `ladder_tiled`, wrapped by
// `point_multiply_pallas`). It computes the same thing, step for step:
//   - decode the peer's u from its 32 bytes with bit 255 masked; a
//     non-canonical u (>= p) is decoded unreduced;
//   - start from P = (u*zr : zr), Q = 2P (zr = 1 when no zr is given);
//   - 254 ladder steps over key bits 253..0 with a deferred swap on
//     bit ^ prev, then a final select on prev;
//   - invert Z, multiply, canonicalize and write 32 bytes.
// Where the TPU kernel padded the batch to whole 1024-lane tiles, each thread
// here owns one lane and the grid masks the ragged end (lane < n).
//
// Constant time: the swap is mask arithmetic on the key bit, and the key
// byte read in each step is indexed by the public loop counter only.
//
// What bounds it on this card: int32 multiply-add issue. A lane performs
// about 2,556 field multiplies and squarings (254 x (5M + 4S) for the ladder,
// 254 S + 11 M for the inversion, 5 for the start), each 210-400 IMADs plus
// ~120 carry ops, and nothing is shared between lanes. What the design does
// about it: nothing yet. This version keeps the 13-bit radix and the op
// sequence of ops/fe.py so that its limbs equal the plain version's; a radix
// that uses 32x32->64 `mad.wide` is later work.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (x25519_ladder_launch), and with g++ for the CPU
// tests (x25519_ladder_host, fe25519_op_host), which run the same per-lane
// code on the host.

#include "fe25519.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

using namespace fe25519;

// One lane: out = x-coordinate bytes of clamp(key) * u. `key` must already
// be clamped (bit 254 set). `zr` is 20 signed-weak limbs, or null for one.
FE_HD void x25519_lane(uint8_t* out, const uint8_t* ubytes, const uint8_t* key,
                       const int32_t* zr_limbs) {
  int32_t b[32];
#pragma unroll
  for (int j = 0; j < 32; j++) b[j] = ubytes[j];  // widen before any shift
  b[31] &= 0x7F;                                   // RFC 7748: mask bit 255
  const Fe u = from_bytes(b);
  Fe zr;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) zr.v[i] = zr_limbs ? zr_limbs[i] : (i == 0);

  // State after the virtual step for bit 254: A = 2P (doubled side),
  // B = P (sum side), prev = 1; the logical low point is prev ? B : A.
  Fe bx = mul(u, zr);
  Fe bz = zr;
  Fe ax, az;
  {
    const Fe a = add(bx, bz);
    const Fe aa = sqr(a);
    const Fe bm = sub(bx, bz);
    const Fe bb = sqr(bm);
    ax = mul(aa, bb);
    const Fe e = sub(aa, bb);
    az = mul(e, mul_small_add(aa, A24, e));
  }
  int32_t prev = (key[31] >> 6) & 1;

#pragma unroll 1
  for (int i = 253; i >= 0; i--) {
    const int32_t bit = (key[i >> 3] >> (i & 7)) & 1;
    const int32_t s = bit ^ prev;
    const Fe x2 = select(s, bx, ax);
    const Fe x3 = select(s, ax, bx);
    const Fe z2 = select(s, bz, az);
    const Fe z3 = select(s, az, bz);

    const Fe a = add(x2, z2);
    const Fe bm = sub(x2, z2);
    const Fe c = add(x3, z3);
    const Fe d = sub(x3, z3);
    const Fe da = mul(d, a);
    const Fe cb = mul(c, bm);
    const Fe aa = sqr(a);
    const Fe bb = sqr(bm);
    bx = sqr(add(da, cb));
    bz = mul(u, sqr(sub(da, cb)));
    ax = mul(aa, bb);
    const Fe e = sub(aa, bb);
    az = mul(e, mul_small_add(aa, A24, e));
    prev = bit;
  }
  const Fe lo_x = select(prev, bx, ax);
  const Fe lo_z = select(prev, bz, az);

  int32_t enc[32];
  to_bytes(enc, mul(lo_x, inv(lo_z)));
#pragma unroll
  for (int j = 0; j < 32; j++) out[j] = (uint8_t)enc[j];
}

#ifdef __CUDACC__

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
x25519_ladder_kernel(uint8_t* __restrict__ out, const uint8_t* __restrict__ u,
                     const uint8_t* __restrict__ k, const int32_t* __restrict__ zr,
                     int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  x25519_lane(out + 32 * lane, u + 32 * lane, k + 32 * lane,
              zr ? zr + NLIMBS * lane : nullptr);
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

extern "C" const char* x25519_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// ---------------------------------------------------------------------------
// Host entries: the same per-lane code on the CPU, for the tests.
// ---------------------------------------------------------------------------
extern "C" void x25519_ladder_host(uint8_t* out, const uint8_t* u, const uint8_t* k,
                                   const int32_t* zr, int64_t n) {
  for (int64_t i = 0; i < n; i++)
    x25519_lane(out + 32 * i, u + 32 * i, k + 32 * i, zr ? zr + NLIMBS * i : nullptr);
}

enum FeOp {
  FE_ADD, FE_SUB, FE_NEG, FE_MUL, FE_SQR, FE_MUL_SMALL_ADD, FE_CANON, FE_INV,
  FE_TO_BYTES, FE_FROM_BYTES
};

// One field op over n lanes. x, y, out: [n, 20] int32 limbs, except that
// FE_TO_BYTES writes and FE_FROM_BYTES reads [n, 32] int32 byte values.
// FE_MUL_SMALL_ADD computes x + A24 * y. Returns 0, or -1 for an unknown op.
extern "C" int fe25519_op_host(int op, int32_t* out, const int32_t* x,
                               const int32_t* y, int64_t n) {
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
