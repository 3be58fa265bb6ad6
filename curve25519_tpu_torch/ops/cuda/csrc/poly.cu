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
// What bounds it on this card: int32 multiply-add issue, ~990 field
// multiplies and ~510 squarings per lane with the inversion; the bytes (the
// 2.5 KB table per lane, read in parts) are far below. At 8 warps per SM (255
// registers a thread) neither the q_table reads nor their decode cost time
// (cp.async slots and decode at use alone gained nothing, PERF.md); what the
// SM lacked was warps to hide the latency of dependent multiply-adds. The
// design runs 12 warps per SM (three blocks of 128, at most 168 registers a
// thread) with no spill:
// - poly_lane's two loops are one, so the code of a double and a PE add
//   appears once (a smaller allocation, and half the loop code to fetch);
// - the PE add reads each coordinate of the entry (ypx, ymx, t2d, z2: 5
//   words of each plane, four 16-byte loads) from the lane's row or the
//   shared table just before the multiply that takes it (add_pe_with,
//   PlaneCoord), so at most 20 of the entry's 80 limbs are live beside the
//   point; a limb is two byte permutes and a shift-add.
// The base table of s, the packed fold-8 table, is copied once per block into
// shared memory and read by index (load_pa); poly_shared_kernel copies its one
// q_table there too.
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
  __shared__ __align__(16) uint32_t tbl[kTableWords];
  copy_shared(tbl, table, kTableWords);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  PlaneRows qt{const_cast<uint32_t*>(planes) + kQtWords * lane};
  poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, qt, PlainPa{tbl});
}

__global__ void __launch_bounds__(kBlock, 3)
poly_shared_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ u,
                   const int32_t* __restrict__ v, const uint32_t* __restrict__ planes,
                   const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kTableWords];
  __shared__ __align__(16) uint32_t qs[kQtWords];
  copy_shared(tbl, table, kTableWords);
  copy_shared(qs, planes, kQtWords);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  PlaneRows qt{qs};
  poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, qt, PlainPa{tbl});
}

// out: [n, 32] uint8; u: [n, 32] and v: [n, 64] int32 digits; planes: the
// lanes' [n, 16, 160] int8 q_tables, or one [16, 160] table when shared != 0
// (16-byte aligned); table: the packed folding-8 table (16-byte aligned).
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
  for (int64_t i = 0; i < n; i++) {
    PlaneRows qt{const_cast<uint32_t*>(planes) + (shared ? 0 : kQtWords * i)};
    poly_lane(out + 32 * i, u + 32 * i, v + 64 * i, qt, PlainPa{table});
  }
}
