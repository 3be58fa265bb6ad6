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
// What bounds it on this card: int32 multiply-add issue (Verify_Init's ~890
// field multiplies and ~1,020 squarings, then ~990 and ~510 for the
// multiply). The fused kernel first ran slower than its two phases run as
// two launches; the design for this card:
// 1. Persistent blocks with aligned phases: one block of 256 threads per SM
//    (the register budget: 255 registers a thread) loops over 256-lane tiles;
//    all its warps run Verify_Init, meet at a barrier, then run the
//    double-scalar multiply, so an SM runs one loop body at a time. Lanes
//    past n skip both parts but still reach the barriers. The scratch holds
//    the resident lanes only: one 2.5 KB row per thread of the grid.
// 2. Asynchronous prefetch: the digits v are public and known before the
//    loop, so the entry of step i+1 is copied (cp.async, 10 x 16 bytes) into
//    the thread's double-buffered slot in shared memory while step i
//    computes; Verify_Init's reads of its earlier entries likewise. The
//    slots are chunk-major across the block's threads (chunk q of slot s of
//    thread t at 16-byte index (10s + q) * 256 + t), so the copies and the
//    16-byte reads of a warp hit distinct banks.
// 3. The scratch layout: canonical 13-bit limbs as int16 (word k of a
//    coordinate = limb 2k | limb 2k+1 << 16), the same 160 bytes an entry as
//    the int8 planes, unpacked with two operations per word.
// The fold-8 table is copied once per block into shared memory and read by
// index (load_pa).
//
// The library owns the launch shape: oneshot_scratch_rows gives the scratch
// rows (grid x block) for n lanes, and oneshot_launch takes the grid from the
// rows it is given, so the kernel never indexes past the scratch.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (oneshot_scratch_rows, oneshot_launch), and with
// g++ for the CPU tests (oneshot_host), which run the same per-lane code,
// layouts and slot order on the host, the copies done at once.

#include "verify_lane.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

constexpr int kOneshotBlock = 256;
constexpr int kChunks = kQtEntryWords / 4;  // 16-byte chunks of an entry

// Scratch rows of the launch for n lanes on a card of `sms` SMs: one block
// per SM at most, each of kOneshotBlock threads (a row each).
extern "C" int oneshot_scratch_rows(int64_t n, int sms) {
  const int64_t blocks = (n + kOneshotBlock - 1) / kOneshotBlock;
  return (int)(blocks < sms ? blocks : sms) * kOneshotBlock;
}

// Coordinate c of an entry in the int16 layout: canonical limbs, two a word.
FE_HD void store_coord16(uint32_t (&w)[kQtEntryWords], int c, const Fe& x) {
  const Fe d = canon(x);
#pragma unroll
  for (int j = 0; j < NLIMBS / 2; j++)
    w[10 * c + j] = (uint32_t)d.v[2 * j] | (uint32_t)d.v[2 * j + 1] << 16;
}

FE_HD void store_entry16(uint32_t* entry, const Pe& e) {
  uint32_t w[kQtEntryWords];
  store_coord16(w, 0, e.ypx);
  store_coord16(w, 1, e.ymx);
  store_coord16(w, 2, e.t2d);
  store_coord16(w, 3, e.z2);
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int q = 0; q < kChunks; q++)
    reinterpret_cast<uint4*>(entry)[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
#else
  for (int k = 0; k < kQtEntryWords; k++) entry[k] = w[k];
#endif
}

FE_HD Pe decode(const uint32_t (&w)[kQtEntryWords]) {
  int32_t limb[4 * NLIMBS];
#pragma unroll
  for (int k = 0; k < kQtEntryWords; k++) {
    limb[2 * k] = (int32_t)(w[k] & 0xFFFF);
    limb[2 * k + 1] = (int32_t)(w[k] >> 16);
  }
  return pe_from_limbs(limb);
}

#ifdef __CUDA_ARCH__
__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
#endif

// The lane's q_table in its scratch row, read through two slots: an entry is
// requested (prefetch) before it is read, in the same order.
struct ScratchRows {
  uint32_t* row;   // kQtWords words, 16-byte aligned
  uint32_t* slot;  // the thread's first word of the slots; chunk q of slot s
                   // at word 4 * (kChunks * s + q) * stride
  int stride;
  int issued, taken;

  FE_HD void store(int i, const Pe& e) { store_entry16(row + i * kQtEntryWords, e); }

  FE_HD void prefetch(int i) {
    uint32_t* dst = slot + 4 * kChunks * (issued & 1) * stride;
    const uint32_t* src = row + i * kQtEntryWords;
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int q = 0; q < kChunks; q++) cp_async16(dst + 4 * q * stride, src + 4 * q);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#else
    for (int q = 0; q < kChunks; q++)
      for (int j = 0; j < 4; j++) dst[4 * q * stride + j] = src[4 * q + j];
#endif
    issued++;
  }

  // Entry i; `more`: another entry has been requested after it.
  FE_HD Pe read(int i, bool more) {
    uint32_t w[kQtEntryWords];
#ifdef __CUDA_ARCH__
    if (more)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
    const uint32_t* src = slot + 4 * kChunks * (taken & 1) * stride;
#pragma unroll
    for (int q = 0; q < kChunks; q++) {
#ifdef __CUDA_ARCH__
      const uint4 c = *reinterpret_cast<const uint4*>(src + 4 * q * stride);
      w[4 * q] = c.x;
      w[4 * q + 1] = c.y;
      w[4 * q + 2] = c.z;
      w[4 * q + 3] = c.w;
#else
      for (int j = 0; j < 4; j++) w[4 * q + j] = src[4 * q * stride + j];
#endif
    }
    taken++;
    return decode(w);
  }

  FE_HD Ext add(const Ext& p, int i, bool more) { return add_pe(p, read(i, more)); }
};

#ifdef __CUDACC__

// Dynamic shared memory: the fold-8 table, then the slots.
constexpr int kOneshotSmemBytes = 4 * kTableWords + 2 * kChunks * 16 * kOneshotBlock;

__global__ void __launch_bounds__(kOneshotBlock, 1)
oneshot_kernel(uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
               uint32_t* __restrict__ scratch, const uint8_t* __restrict__ pk,
               const int32_t* __restrict__ u, const int32_t* __restrict__ v,
               const uint32_t* __restrict__ table, int64_t n) {
  extern __shared__ __align__(16) uint32_t smem[];
  for (int c = threadIdx.x; c < kTableWords / 4; c += blockDim.x)
    reinterpret_cast<uint4*>(smem)[c] = reinterpret_cast<const uint4*>(table)[c];
  __syncthreads();
  const int tid = threadIdx.x;
  ScratchRows qt{scratch + (int64_t)kQtWords * (blockIdx.x * kOneshotBlock + tid),
                 smem + kTableWords + 4 * tid, kOneshotBlock, 0, 0};
  const PlainPa pa{smem};
  for (int64_t first = (int64_t)blockIdx.x * kOneshotBlock; first < n;
       first += (int64_t)gridDim.x * kOneshotBlock) {
    const int64_t lane = first + tid;
    if (lane < n) ok[lane] = (uint8_t)build_qtable(qt, pk + 32 * lane);
    __syncthreads();
    if (lane < n) poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, qt, pa);
    __syncthreads();
  }
}

// out: [n, 32] uint8 enc(R'); ok: [n] bool; scratch: [rows, 16, 160] bytes,
// 16-byte aligned, overwritten, rows a positive multiple of the block (the
// grid is rows / block; oneshot_scratch_rows picks it); pk: [n, 32] uint8;
// u: [n, 32] and v: [n, 64] int32 digits; table: the packed folding-8 table.
// Launches on `stream`, allocates nothing, does not synchronize and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for rows that
// are not such a multiple.
extern "C" int oneshot_launch(void* out, void* ok, void* scratch, int64_t rows, const void* pk,
                              const void* u, const void* v, const void* table, int64_t n,
                              void* stream) {
  if (n > 0) {
    if (rows <= 0 || rows % kOneshotBlock != 0) return (int)cudaErrorInvalidValue;
    const int grid = (int)(rows / kOneshotBlock);
    const cudaError_t rc = cudaFuncSetAttribute(
        oneshot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOneshotSmemBytes);
    if (rc != cudaSuccess) return (int)rc;
    oneshot_kernel<<<grid, kOneshotBlock, kOneshotSmemBytes, (cudaStream_t)stream>>>(
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
    uint32_t row[kQtWords], slot[2 * kQtEntryWords];
    ScratchRows qt{row, slot, 1, 0, 0};
    ok[i] = (uint8_t)build_qtable(qt, pk + 32 * i);
    poly_lane(out + 32 * i, u + 32 * i, v + 64 * i, qt, PlainPa{table});
    if (scratch)
      for (int k = 0; k < kQtWords; k++) scratch[kQtWords * i + k] = row[k];
  }
}
