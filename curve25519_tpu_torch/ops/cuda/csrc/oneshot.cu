// oneshot.cu -- fused one-shot Ed25519 verify: Verify_Init and the
// double-scalar multiply of verify_lane.cuh in one launch (CUDA, sm_90a).
//
// Replaces the TPU kernel curve25519_tpu/ops/pallas/verify_kernel.py
// `_oneshot_kernel` (verify_oneshot_tiled): enc(s*G + h*(-Q)) and the
// decode's ok flag per lane, the q_table never leaving the kernel. The TPU
// kept it in VMEM; here 2.5 KB per lane fits neither the registers nor, at a
// useful occupancy, shared memory, so each resident lane owns a row of a
// global scratch that the wrapper allocates and nothing reads after the
// launch.
//
// What bounds it on this card: the field products (Verify_Init's ~890
// field multiplies and ~1,020 squarings, then ~990 and ~510 for the
// multiply). What the design does about it: both phases are the wide-core
// lanes of verify_lane.cuh, verify_init_lane (verify.cu's) writing the
// lane's q_table into its scratch row in the planes' layout, then poly_lane
// (poly.cu's) reading that row back a coordinate at a time; at most 128
// registers a thread, 16 warps per SM. A thread reads only the row it
// wrote, so the rows need no copy through shared memory. What the fusion
// has to mind is the instruction cache: the two phases are about 23,000
// SASS instructions (13,700 and 9,400), and where warps of one SM ran
// different phases the kernel took 16.2 ms against 12.8 for the two
// kernels back to back (PERF.md section 6). So one block of
// 512 threads per SM, persistent, loops over 512-lane tiles, and all its
// warps meet at a barrier after Verify_Init: an SM runs one phase's code at
// a time but for the short turn from a tile's multiply to the next tile's
// Verify_Init (a second barrier there cost 1%). Lanes past n skip both
// phases but still reach the barrier. The scratch holds the resident lanes
// only: one row per thread of the grid. The fold-8 word table is copied
// once per block into shared memory and read by index.
//
// The library owns the launch shape: oneshot_scratch_rows gives the scratch
// rows (grid x block) for n lanes, and oneshot_launch takes the grid from the
// rows it is given, so the kernel never indexes past the scratch.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (oneshot_scratch_rows, oneshot_launch), and with
// g++ for the CPU tests (oneshot_host), which run the same per-lane code and
// scratch layout on the host.

#include "verify_lane.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

constexpr int kOneshotBlock = 512;

// Scratch rows of the launch for n lanes on a card of `sms` SMs: one block
// per SM at most, each of kOneshotBlock threads (a row each).
extern "C" int oneshot_scratch_rows(int64_t n, int sms) {
  const int64_t blocks = (n + kOneshotBlock - 1) / kOneshotBlock;
  return (int)(blocks < sms ? blocks : sms) * kOneshotBlock;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(kOneshotBlock, 1)
oneshot_kernel(uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
               uint32_t* __restrict__ scratch, const uint8_t* __restrict__ pk,
               const int32_t* __restrict__ u, const int32_t* __restrict__ v,
               const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kBaseWords];
  for (int c = threadIdx.x; c < kBaseWords / 4; c += blockDim.x)
    reinterpret_cast<uint4*>(tbl)[c] = reinterpret_cast<const uint4*>(table)[c];
  __syncthreads();
  uint32_t* row = scratch + kQtWords * ((int64_t)blockIdx.x * kOneshotBlock + threadIdx.x);
#pragma unroll 1
  for (int64_t tile = (int64_t)blockIdx.x * kOneshotBlock; tile < n;
       tile += (int64_t)gridDim.x * kOneshotBlock) {
    const int64_t lane = tile + threadIdx.x;
    if (lane < n) verify_init_lane(row, ok + lane, pk + 32 * lane);
    __syncthreads();
    if (lane < n) poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, row, tbl);
  }
}

// out: [n, 32] uint8 enc(R'); ok: [n] bool; scratch: [rows, 16, 160] bytes,
// 16-byte aligned, overwritten, rows a positive multiple of the block (the
// grid is rows / block; oneshot_scratch_rows picks it); pk: [n, 32] uint8;
// u: [n, 32] and v: [n, 64] int32 digits; table: the fold-8 word table.
// Launches on `stream`, allocates nothing, does not synchronize and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for rows that
// are not such a multiple.
extern "C" int oneshot_launch(void* out, void* ok, void* scratch, int64_t rows, const void* pk,
                              const void* u, const void* v, const void* table, int64_t n,
                              void* stream) {
  if (n > 0) {
    if (rows <= 0 || rows % kOneshotBlock != 0) return (int)cudaErrorInvalidValue;
    oneshot_kernel<<<(unsigned)(rows / kOneshotBlock), kOneshotBlock, 0,
                     (cudaStream_t)stream>>>(
        (uint8_t*)out, (uint8_t*)ok, (uint32_t*)scratch, (const uint8_t*)pk, (const int32_t*)u,
        (const int32_t*)v, (const uint32_t*)table, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// Host entry: the same per-lane code on the CPU, for the tests. scratch:
// null, or [n, 16, 160] bytes that receive each lane's q_table as the
// kernel's scratch row holds it.
extern "C" void oneshot_host(uint8_t* out, uint8_t* ok, uint32_t* scratch, const uint8_t* pk,
                             const int32_t* u, const int32_t* v, const uint32_t* table,
                             int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    uint32_t row[kQtWords];
    verify_init_lane(row, ok + i, pk + 32 * i);
    poly_lane(out + 32 * i, u + 32 * i, v + 64 * i, row, table);
    if (scratch)
      for (int k = 0; k < kQtWords; k++) scratch[kQtWords * i + k] = row[k];
  }
}
