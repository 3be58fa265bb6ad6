// poly.cu -- the Ed25519 double-scalar multiply enc(s*G + h*(-Q)), one lane
// per thread (CUDA, sm_90a).
//
// Replaces the TPU kernel curve25519_tpu/ops/pallas/verify_kernel.py
// `_poly_kernel` in both of its launchers: poly_mult_tiled -> poly_kernel (a
// q_table per lane) and poly_mult_tiled_shared -> poly_shared_kernel (one
// q_table for every lane). The lane code is poly_lane of verify_lane.cuh,
// which the fused one-shot kernel (oneshot.cu) runs too; the q_tables are the
// verify context's int8 planes, [16, 160] bytes per table, as
// verify_init_kernel (verify.cu) writes them and the JAX context holds them.
// Where the TPU padded to 1024-lane tiles, each thread owns one lane and the
// grid masks lane < n.
//
// What bounds it on this card: the field products, ~990 multiplies and
// ~510 squarings per lane with the inversion; the bytes (the 2.5 KB table
// per lane, read in parts) are far below. What the design does about it:
// the lane runs on the wide field core, fe25519_wide.cuh (ten 32-bit limbs
// in radix 2^25.5, a multiply 100 `IMAD.WIDE.U32`), with the point formulas
// of edwards25519_wide.cuh, as Verify_Init does. The 13-bit radix stays only
// where an entry is read: each coordinate of a PE add's entry (5 words of
// each plane, four 16-byte loads) is decoded and converted to wide limbs
// just before the multiply that takes it (PlaneEntry), so at most one
// coordinate of the entry is live beside the point. Both loops of the
// multiply are one rolled loop, so the code of a double and a PE add
// appears once. At most 168 registers a thread under
// __launch_bounds__(128, 3): three blocks, 12 warps, per SM. The lane fits
// 128 registers with no spill too, but at 16 warps per SM it ran 5% slower
// (PERF.md section 6).
// The base table of s, edwards_kernel.word_table(8) (24 KB), is copied once
// per block into shared memory and read by index; poly_shared_kernel copies
// its one q_table there too.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (poly_launch), and with g++ for the CPU tests
// (poly_host), which run the same per-lane code on the host.

#include "verify_lane.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int kBlock = 128;

__device__ __forceinline__ void copy_shared(uint32_t* dst, const uint32_t* src, int words) {
  for (int c = threadIdx.x; c < words / 4; c += blockDim.x)
    reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(src)[c];
}

__global__ void __launch_bounds__(kBlock, 3)
poly_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ u,
            const int32_t* __restrict__ v, const uint32_t* __restrict__ planes,
            const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kBaseWords];
  copy_shared(tbl, table, kBaseWords);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, planes + kQtWords * lane, tbl);
}

__global__ void __launch_bounds__(kBlock, 3)
poly_shared_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ u,
                   const int32_t* __restrict__ v, const uint32_t* __restrict__ planes,
                   const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kBaseWords];
  __shared__ __align__(16) uint32_t qs[kQtWords];
  copy_shared(tbl, table, kBaseWords);
  copy_shared(qs, planes, kQtWords);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, qs, tbl);
}

// out: [n, 32] uint8; u: [n, 32] and v: [n, 64] int32 digits; planes: the
// lanes' [n, 16, 160] int8 q_tables, or one [16, 160] table when shared != 0
// (16-byte aligned); table: the fold-8 word table (16-byte aligned).
// Launches on `stream`, allocates nothing, does not synchronize and returns
// cudaGetLastError() (0 on success).
extern "C" int poly_launch(void* out, const void* u, const void* v, const void* planes,
                           int shared, const void* table, int64_t n, void* stream) {
  if (n > 0) {
    auto kernel = shared ? poly_shared_kernel : poly_kernel;
    kernel<<<(unsigned)((n + kBlock - 1) / kBlock), kBlock, 0, (cudaStream_t)stream>>>(
        (uint8_t*)out, (const int32_t*)u, (const int32_t*)v, (const uint32_t*)planes,
        (const uint32_t*)table, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// Host entry: the same per-lane code on the CPU, for the tests.
extern "C" void poly_host(uint8_t* out, const int32_t* u, const int32_t* v,
                          const uint32_t* planes, int shared, const uint32_t* table, int64_t n) {
  for (int64_t i = 0; i < n; i++)
    poly_lane(out + 32 * i, u + 32 * i, v + 64 * i, planes + (shared ? 0 : kQtWords * i), table);
}
