// basemult.cu -- folding base-point multiply, one lane per thread (CUDA,
// sm_90a).
//
// Replaces the TPU kernel curve25519_tpu/ops/pallas/edwards_kernel.py
// `_basemult_kernel` (launched by `base_mult_tiled`, wrapped by
// `base_mult_pallas`): from the fold digits of a scalar (32 digits over the
// 256-entry folding-8 table, or 64 over the 16-entry folding-4 table) it
// computes S = a*G with a Z-randomized start, optionally adds a PE
// blinding point BP, and ends in one of four epilogues:
//   0 "affine"  : (X/Z, Y/Z) limbs               -> out [n, 40] int32
//   1 "mont_u"  : u = (Z+Y)/(Z-Y) limbs, twice    -> out [n, 40] int32
//   2 "pk"      : compressed point bytes          -> out [n, 32] uint8
//   3 "u_bytes" : enc(u) bytes                    -> out [n, 32] uint8
// Where the TPU padded the batch to 1024-lane tiles, each thread owns one
// lane and the grid masks lane < n.
//
// What bounds it on this card: issue of int32 work. A fold-8 lane does ~360
// field multiplies and ~380 squarings (~220 K IMAD) and, for the constant-
// time table lookup, reads all 256 entries at each of its 32 steps: ~8 K
// masked ORs per step, ~260 K over the multiply. What the design does about
// it: the lookup reads a table packed two limbs per word from shared memory
// (one copy per block, broadcast reads, 16-byte loads), which halves the
// selects against 60 separate limbs. The sign kernel's int8 one-hot
// mma.sync gather (gather_mma.cuh) is the next step for this kernel.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (basemult_launch), and with g++ for the CPU
// tests (basemult_host), which run the same per-lane code on the host.

#include "edwards25519.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

using namespace ed25519;

enum Mode { MODE_AFFINE = 0, MODE_MONT_U = 1, MODE_PK = 2, MODE_U_BYTES = 3 };

// One lane. zr: 20 limbs or null for one; bp: 80 limbs (ypx, ymx, t2d, z2)
// or null; out: 32 bytes (uint8) for the byte modes, else 40 int32 limbs.
template <int NFOLDS>
FE_HD void basemult_lane(void* out, const int32_t* cut, const int32_t* zr,
                         const int32_t* bp, const uint32_t* tbl, int mode) {
  const Fe z0 = zr ? load_fe(zr) : one();
  Ext s = base_mult<256 / NFOLDS>(cut, z0, ScanGather<1 << NFOLDS>{tbl});
  if (bp) s = add_pe(s, bp);
  // one inversion: of Z for the affine and pk epilogues, of Z - Y for u
  const bool is_u = mode == MODE_MONT_U || mode == MODE_U_BYTES;
  const Fe di = inv(is_u ? sub(s.z, s.y) : s.z);
  if (mode == MODE_PK || mode == MODE_U_BYTES) {
    int32_t enc[32];
    if (mode == MODE_PK)
      pack_point(enc, mul(s.x, di), mul(s.y, di));
    else
      to_bytes(enc, mul(add(s.z, s.y), di));
    uint8_t* o = (uint8_t*)out;
#pragma unroll
    for (int j = 0; j < 32; j++) o[j] = (uint8_t)enc[j];
    return;
  }
  const Fe a = is_u ? mul(add(s.z, s.y), di) : mul(s.x, di);
  const Fe b = is_u ? a : mul(s.y, di);
  int32_t* o = (int32_t*)out;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    o[i] = a.v[i];
    o[NLIMBS + i] = b.v[i];
  }
}

FE_HD int64_t out_stride(int mode) { return mode >= MODE_PK ? 32 : 4 * 2 * NLIMBS; }

#ifdef __CUDACC__

constexpr int kBlock = 128;

template <int NFOLDS>
__device__ __forceinline__ void basemult_body(char* out, const int32_t* cut, const int32_t* zr,
                                              int64_t zr_stride, const int32_t* bp,
                                              int64_t bp_stride, const uint32_t* table,
                                              int mode, int64_t n) {
  constexpr int kWords = (1 << NFOLDS) * kEntryWords;
  __shared__ __align__(16) uint32_t tbl[kWords];
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  basemult_lane<NFOLDS>(out + out_stride(mode) * lane, cut + (256 / NFOLDS) * lane,
                        zr ? zr + zr_stride * lane : nullptr,
                        bp ? bp + bp_stride * lane : nullptr, tbl, mode);
}

__global__ void __launch_bounds__(kBlock)
basemult_fold8_kernel(char* out, const int32_t* __restrict__ cut, const int32_t* __restrict__ zr,
                      int64_t zr_stride, const int32_t* __restrict__ bp, int64_t bp_stride,
                      const uint32_t* __restrict__ table, int mode, int64_t n) {
  basemult_body<8>(out, cut, zr, zr_stride, bp, bp_stride, table, mode, n);
}

__global__ void __launch_bounds__(kBlock)
basemult_fold4_kernel(char* out, const int32_t* __restrict__ cut, const int32_t* __restrict__ zr,
                      int64_t zr_stride, const int32_t* __restrict__ bp, int64_t bp_stride,
                      const uint32_t* __restrict__ table, int mode, int64_t n) {
  basemult_body<4>(out, cut, zr, zr_stride, bp, bp_stride, table, mode, n);
}

// out: [n, 32] uint8 or [n, 40] int32 (by mode); cut: [n, 256/nfolds] int32;
// zr: [n, 20] int32 rows at zr_stride (0: one shared row) or null; bp: [n, 80]
// int32 rows at bp_stride or null; table: the packed folding table for
// nfolds, on the device. Launches on `stream`, allocates nothing, does not
// synchronize. Returns cudaGetLastError() (0 on success), or -1 for a bad
// nfolds or mode.
extern "C" int basemult_launch(void* out, const void* cut, const void* zr, int64_t zr_stride,
                               const void* bp, int64_t bp_stride, const void* table,
                               int nfolds, int mode, int64_t n, void* stream) {
  if ((nfolds != 8 && nfolds != 4) || mode < 0 || mode > 3) return -1;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);
    auto kernel = nfolds == 8 ? basemult_fold8_kernel : basemult_fold4_kernel;
    kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
        (char*)out, (const int32_t*)cut, (const int32_t*)zr, zr_stride, (const int32_t*)bp,
        bp_stride, (const uint32_t*)table, mode, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return code == -1 ? "bad nfolds or mode" : cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// Host entry: the same per-lane code on the CPU, for the tests.
extern "C" int basemult_host(void* out, const int32_t* cut, const int32_t* zr,
                             int64_t zr_stride, const int32_t* bp, int64_t bp_stride,
                             const uint32_t* table, int nfolds, int mode, int64_t n) {
  if ((nfolds != 8 && nfolds != 4) || mode < 0 || mode > 3) return -1;
  for (int64_t i = 0; i < n; i++) {
    char* o = (char*)out + out_stride(mode) * i;
    const int32_t* z = zr ? zr + zr_stride * i : nullptr;
    const int32_t* b = bp ? bp + bp_stride * i : nullptr;
    if (nfolds == 8)
      basemult_lane<8>(o, cut + 32 * i, z, b, table, mode);
    else
      basemult_lane<4>(o, cut + 64 * i, z, b, table, mode);
  }
  return 0;
}
