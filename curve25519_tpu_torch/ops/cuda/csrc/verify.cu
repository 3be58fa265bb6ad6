// verify.cu -- Ed25519 Verify_Init, one lane per thread (CUDA, sm_90a).
//
// Replaces the TPU kernel curve25519_tpu/ops/pallas/verify_kernel.py
// `_vinit_kernel` (verify_init_tiled) -> verify_init_kernel: decode -Q and
// build its 16-entry q_table, emitted as the context's int8 planes with the
// decode's ok flag. The lane (verify_init_lane) and the planes' layout are
// verify_lane.cuh's; the double-scalar multiply that reads the planes is
// poly.cu, and the fused one-shot kernel oneshot.cu runs the same lane.
// Where the TPU padded to 1024-lane tiles, each thread owns one lane and the
// grid masks lane < n.
//
// What bounds it on this card: the field products. Per lane, Verify_Init
// is 891 field multiplies and 1,024 squarings (192 doublings, 11 PE adds,
// 15 PE conversions, the sqrt ratio); the bytes (32 in, the 2,560-byte table
// and the flag out) are a sixth of the products' time. What the design
// does about it: the lane runs on the ladder's wide core, fe25519_wide.cuh
// (ten 32-bit limbs in radix 2^25.5, a multiply 100 `IMAD.WIDE.U32` against
// the 13-bit core's 400 int32 IMADs), with the point formulas of
// edwards25519_wide.cuh, which give the same field elements as the plain
// version's. The 13-bit radix is kept only where the lane crosses the
// planes: each entry is canonicalized, converted to twenty 13-bit limbs
// and split into the lo and hi planes as soon as it is made. The 192
// doublings run first and the 11 subset-sum adds after them, each reading
// both of its entries back from the planes, a coordinate at a time, just
// before the multiply that takes it; the base entry's Z and T come from its
// 2Z and 2dT by a constant multiply (22 multiplies a lane). So no point
// stays live across the adds, and the lane fits 128 registers with no
// spill: 16 warps per SM. Every loop is rolled (the 64 doublings are one
// loop): about 13,700 SASS instructions, against 36,200 on the 13-bit core.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (verify_init_launch), and with g++ for the CPU
// tests (verify_init_host), which run the same per-lane code on the host.

#include "verify_lane.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int kBlock = 128;

// At most 128 registers a thread: four blocks, 16 warps, per SM. The lane
// fits them with no spill (ptxas; PERF.md section 6 times this build
// against 130 registers with no minimum, 12 warps, and others).
__global__ void __launch_bounds__(kBlock, 4)
verify_init_kernel(uint32_t* __restrict__ planes, uint8_t* __restrict__ ok,
                   const uint8_t* __restrict__ pk, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  verify_init_lane(planes + kQtWords * lane, ok + lane, pk + 32 * lane);
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

// Host entry: the same per-lane code on the CPU, for the tests.
extern "C" void verify_init_host(uint32_t* planes, uint8_t* ok, const uint8_t* pk, int64_t n) {
  for (int64_t i = 0; i < n; i++)
    verify_init_lane(planes + kQtWords * i, ok + i, pk + 32 * i);
}

