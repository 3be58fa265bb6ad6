// verify.cu -- Ed25519 Verify_Init and the double-scalar multiply, one lane
// per thread (CUDA, sm_90a).
//
// Replaces two TPU kernels of curve25519_tpu/ops/pallas/verify_kernel.py:
// - `_vinit_kernel` (verify_init_tiled) -> verify_init_kernel: Verify_Init,
//   emitted as the context's int8 planes with the decode's ok flag;
// - `_poly_kernel` (poly_mult_tiled / poly_mult_tiled_shared) -> poly_kernel
//   (a q_table per lane) and poly_shared_kernel (one q_table for every lane):
//   enc(s*G + h*(-Q)).
// The lane code and the q_table layout are verify_lane.cuh's; the fused
// one-shot kernel is oneshot.cu. Where the TPU padded to 1024-lane tiles,
// each thread owns one lane and the grid masks lane < n.
//
// Table reads: the 256-entry base table of s is one entry of the packed
// folding-8 table in shared memory (load_pa). The q_table entry is 10
// 16-byte loads: from the lane's row in global memory (poly_kernel) or from
// shared memory (poly_shared_kernel copies the one table once per block).
// 2.5 KB per lane does not fit shared memory at a useful occupancy.
//
// What bounds it on this card: int32 multiply-add issue. Per lane, Verify_Init
// is ~890 field multiplies and ~1,020 squarings, the double-scalar multiply
// with its inversion ~990 and ~510; the bytes (the 2.5 KB table per lane
// written once and read ~4 times) are far below. What the design does about
// it: nothing beyond the shared field core yet; every loop is rolled to keep the
// code and the registers small.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (verify_init_launch, poly_launch), and with g++
// for the CPU tests (verify_init_host, poly_host, sqrt_ratio_host), which run
// the same per-lane code on the host.

#include "verify_lane.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#ifdef __CUDACC__

constexpr int kBlock = 128;

__device__ __forceinline__ void load_shared(uint32_t* dst, const uint32_t* src, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kBlock)
verify_init_kernel(uint32_t* __restrict__ planes, uint8_t* __restrict__ ok,
                   const uint8_t* __restrict__ pk, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  PlaneRows qt{planes + kQtWords * lane};
  ok[lane] = (uint8_t)build_qtable(qt, pk + 32 * lane);
}

__global__ void __launch_bounds__(kBlock)
poly_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ u,
            const int32_t* __restrict__ v, const uint32_t* __restrict__ planes,
            const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kTableWords];
  load_shared(tbl, table, kTableWords);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  PlaneRows qt{const_cast<uint32_t*>(planes) + kQtWords * lane};
  poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, qt, PlainPa{tbl});
}

__global__ void __launch_bounds__(kBlock)
poly_shared_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ u,
                   const int32_t* __restrict__ v, const uint32_t* __restrict__ planes,
                   const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kTableWords];
  __shared__ __align__(16) uint32_t qs[kQtWords];
  load_shared(tbl, table, kTableWords);
  load_shared(qs, planes, kQtWords);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  PlaneRows qt{qs};
  poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, qt, PlainPa{tbl});
}

static unsigned grid(int64_t n) { return (unsigned)((n + kBlock - 1) / kBlock); }

// planes: [n, 16, 160] int8 out (16-byte aligned); ok: [n] bool out; pk:
// [n, 32] uint8. Every launch entry launches on `stream`, allocates nothing,
// does not synchronize and returns cudaGetLastError() (0 on success).
extern "C" int verify_init_launch(void* planes, void* ok, const void* pk, int64_t n,
                                  void* stream) {
  if (n > 0)
    verify_init_kernel<<<grid(n), kBlock, 0, (cudaStream_t)stream>>>(
        (uint32_t*)planes, (uint8_t*)ok, (const uint8_t*)pk, n);
  return (int)cudaGetLastError();
}

// out: [n, 32] uint8; u: [n, 32] and v: [n, 64] int32 digits; planes: the
// lanes' [n, 16, 160] int8 q_tables, or one [16, 160] table when shared != 0
// (16-byte aligned); table: the packed folding-8 table.
extern "C" int poly_launch(void* out, const void* u, const void* v, const void* planes,
                           int shared, const void* table, int64_t n, void* stream) {
  if (n > 0) {
    auto kernel = shared ? poly_shared_kernel : poly_kernel;
    kernel<<<grid(n), kBlock, 0, (cudaStream_t)stream>>>(
        (uint8_t*)out, (const int32_t*)u, (const int32_t*)v, (const uint32_t*)planes,
        (const uint32_t*)table, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// ---------------------------------------------------------------------------
// Host entries: the same per-lane code on the CPU, for the tests.
// ---------------------------------------------------------------------------
extern "C" void verify_init_host(uint32_t* planes, uint8_t* ok, const uint8_t* pk, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    PlaneRows qt{planes + kQtWords * i};
    ok[i] = (uint8_t)build_qtable(qt, pk + 32 * i);
  }
}

extern "C" void poly_host(uint8_t* out, const int32_t* u, const int32_t* v,
                          const uint32_t* planes, int shared, const uint32_t* table, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    PlaneRows qt{const_cast<uint32_t*>(planes) + (shared ? 0 : kQtWords * i)};
    poly_lane(out + 32 * i, u + 32 * i, v + 64 * i, qt, PlainPa{table});
  }
}

// x, u, v: [n, 20] int32 limbs; ok: [n] int32 (fe25519::sqrt_ratio).
extern "C" void sqrt_ratio_host(int32_t* x, int32_t* ok, const int32_t* u, const int32_t* v,
                                int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    const Fe r = sqrt_ratio(load_fe(u + NLIMBS * i), load_fe(v + NLIMBS * i), ok[i]);
    for (int k = 0; k < NLIMBS; k++) x[NLIMBS * i + k] = r.v[k];
  }
}
