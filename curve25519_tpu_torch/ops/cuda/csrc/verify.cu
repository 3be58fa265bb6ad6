// verify.cu -- Ed25519 Verify_Init, one lane per thread (CUDA, sm_90a).
//
// Replaces the TPU kernel curve25519_tpu/ops/pallas/verify_kernel.py
// `_vinit_kernel` (verify_init_tiled) -> verify_init_kernel: decode -Q and
// build its 16-entry q_table, emitted as the context's int8 planes with the
// decode's ok flag. The lane code and the q_table layout are
// verify_lane.cuh's; the double-scalar multiply that reads the planes is
// poly.cu, the fused one-shot kernel oneshot.cu. Where the TPU padded to
// 1024-lane tiles, each thread owns one lane and the grid masks lane < n.
//
// What bounds it on this card: int32 multiply-add issue. Per lane,
// Verify_Init is ~890 field multiplies and ~1,020 squarings; the bytes (the
// 2.5 KB table per lane, written once) are far below. What the design does
// about it: nothing beyond the shared field core yet; every loop is rolled to
// keep the code and the registers small.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (verify_init_launch), and with g++ for the CPU
// tests (verify_init_host, sqrt_ratio_host), which run the same per-lane code
// on the host.

#include "verify_lane.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#ifdef __CUDACC__

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
verify_init_kernel(uint32_t* __restrict__ planes, uint8_t* __restrict__ ok,
                   const uint8_t* __restrict__ pk, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  PlaneRows qt{planes + kQtWords * lane};
  ok[lane] = (uint8_t)build_qtable(qt, pk + 32 * lane);
}

static unsigned grid(int64_t n) { return (unsigned)((n + kBlock - 1) / kBlock); }

// planes: [n, 16, 160] int8 out (16-byte aligned); ok: [n] bool out; pk:
// [n, 32] uint8. Launches on `stream`, allocates nothing, does not
// synchronize and returns cudaGetLastError() (0 on success).
extern "C" int verify_init_launch(void* planes, void* ok, const void* pk, int64_t n,
                                  void* stream) {
  if (n > 0)
    verify_init_kernel<<<grid(n), kBlock, 0, (cudaStream_t)stream>>>(
        (uint32_t*)planes, (uint8_t*)ok, (const uint8_t*)pk, n);
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

// x, u, v: [n, 20] int32 limbs; ok: [n] int32 (fe25519::sqrt_ratio).
extern "C" void sqrt_ratio_host(int32_t* x, int32_t* ok, const int32_t* u, const int32_t* v,
                                int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    const Fe r = sqrt_ratio(load_fe(u + NLIMBS * i), load_fe(v + NLIMBS * i), ok[i]);
    for (int k = 0; k < NLIMBS; k++) x[NLIMBS * i + k] = r.v[k];
  }
}
