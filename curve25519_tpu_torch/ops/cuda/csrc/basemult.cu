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
// lane and the grid masks lane < n. Three kernels:
//
// basemult_fold8_kernel (every mode). What bounds it on this card: the
// int32 multiply-adds. A fold-8 lane does ~360 field multiplies and ~380
// squarings (~220 K IMAD) on the 13-bit core. Its 32 constant-time table
// reads run on the tensor cores (gather_mma.cuh): per warp and read, 240
// int8 one-hot mma.sync products over the table in shared memory, in
// B-fragment order, where a masked scan of all 256 entries costs ~8 K ALU
// operations per lane and read, about as much as the arithmetic. No address
// and no branch depends on a digit. mma.sync needs the whole warp: a warp
// wholly past n leaves at once, the lanes of a partial warp recompute lane
// n - 1 and store nothing. Shared memory per block of 128 threads: the 30 KB
// table and four warps' staging rows, 64 KB of dynamic memory.
//
// basemult_fold4_kernel (the byte modes, the API's fast public key). What
// bounds it: the FMA pipe's field products, 63 x (4 M + 4 S + 7 M) and the
// inversion, ~1,200 multiplies and squarings a lane. So the lane runs on the
// wide core, fe25519_wide.cuh (a multiply is 100 `IMAD.WIDE.U32` against
// the 13-bit core's ~420 IMAD), through the point formulas of
// edwards25519_wide.cuh; the bytes depend only on the point, not on its
// limbs. The 64 table reads
// are a masked scan of all 16 entries, each stored as the 8 little-endian
// words of its canonical coordinates (edwards_kernel.word_table, 1.5 KB in
// shared memory, broadcast 16-byte reads, FOLD4_SCAN_UNROLL entries a loop
// trip): 384 LOP3 a read, on the ALU pipe, which the field work leaves
// about two thirds idle (tools/ladder_probe.py). zr and BP arrive as
// 13-bit limbs and are converted once per lane (weak_limbs.cuh), BP a
// coordinate at a time just before the multiply that takes it. 256 threads
// a block, at most 128 registers a thread: 16 warps per SM.
//
// basemult_fold4_limbs_kernel (affine, mont_u): the 13-bit lane with the
// masked scan of the packed table (two limbs per word). These modes emit the
// plain version's weak 13-bit limbs, which only the same radix and the same
// ops reproduce.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (basemult_launch), and with g++ for the CPU
// tests (basemult_host), which run the same per-lane code on the host, the
// fold-8 reads by the masked scan or by the host emulation of the tensor-core
// gather.

#include "fold4_wide.cuh"
#include "gather_mma.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

using namespace ed25519;

enum Mode { MODE_AFFINE = 0, MODE_MONT_U = 1, MODE_PK = 2, MODE_U_BYTES = 3 };

// One lane. zr: 20 limbs or null for one; bp: 80 limbs (ypx, ymx, t2d, z2)
// or null; out: 32 bytes (uint8) for the byte modes, else 40 int32 limbs, or
// null to store nothing; gather: a constant-time gather policy of base_mult
// over the table of the NCUTS digits.
template <int NCUTS, class Gather>
FE_HD void basemult_lane(void* out, const int32_t* cut, const int32_t* zr, const int32_t* bp,
                         int mode, const Gather& gather) {
  const Fe z0 = zr ? load_fe(zr) : one();
  Ext s = base_mult<NCUTS>(cut, z0, gather);
  if (!out) return;
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
// Dynamic shared memory of the fold-8 kernel: the table in B order, then one
// staging area per warp.
constexpr int kFold8SmemBytes = 4 * (kMmaTableWords + (kBlock / 32) * kStageWords);

__global__ void __launch_bounds__(kBlock)
basemult_fold8_kernel(char* out, const int32_t* __restrict__ cut, const int32_t* __restrict__ zr,
                      int64_t zr_stride, const int32_t* __restrict__ bp, int64_t bp_stride,
                      const uint32_t* __restrict__ table, int mode, int64_t n) {
  extern __shared__ __align__(16) uint32_t smem[];
  const MmaGather gather = load_mma_table(smem, table);
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~(int64_t)31) >= n) return;  // the whole warp is past n
  const int64_t row = lane < n ? lane : n - 1;
  basemult_lane<32>(lane < n ? out + out_stride(mode) * lane : nullptr, cut + 32 * row,
                    zr ? zr + zr_stride * row : nullptr, bp ? bp + bp_stride * row : nullptr,
                    mode, gather);
}

// The byte modes on the wide lane, 256 threads a block. At most 128
// registers a thread: two blocks, 16 warps, per SM (tools/ladder_probe.py
// times other shapes against it).
constexpr int kFold4Block = 256;

__global__ void __launch_bounds__(kFold4Block, 2)
basemult_fold4_kernel(char* out, const int32_t* __restrict__ cut, const int32_t* __restrict__ zr,
                      int64_t zr_stride, const int32_t* __restrict__ bp, int64_t bp_stride,
                      const uint32_t* __restrict__ table, int mode, int64_t n) {
  constexpr int kTableWords = fold4_wide::kNent * fold4_wide::kWords;
  __shared__ __align__(16) uint32_t tbl[kTableWords];
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  fold4_wide::lane((uint8_t*)out + 32 * lane, cut + 64 * lane,
                   zr ? zr + zr_stride * lane : nullptr, bp ? bp + bp_stride * lane : nullptr,
                   mode == MODE_PK, tbl);
}

// The limb modes on the 13-bit lane.
__global__ void __launch_bounds__(kBlock)
basemult_fold4_limbs_kernel(char* out, const int32_t* __restrict__ cut,
                            const int32_t* __restrict__ zr, int64_t zr_stride,
                            const int32_t* __restrict__ bp, int64_t bp_stride,
                            const uint32_t* __restrict__ table, int mode, int64_t n) {
  constexpr int kWords = 16 * kEntryWords;
  __shared__ __align__(16) uint32_t tbl[kWords];
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  basemult_lane<64>(out + out_stride(mode) * lane, cut + 64 * lane,
                    zr ? zr + zr_stride * lane : nullptr, bp ? bp + bp_stride * lane : nullptr,
                    mode, ScanGather<16>{tbl});
}

// out: [n, 32] uint8 or [n, 40] int32 (by mode); cut: [n, 256/nfolds] int32;
// zr: [n, 20] int32 rows at zr_stride (0: one shared row) or null; bp: [n, 80]
// int32 rows at bp_stride or null; table, on the device, the one that the
// launch of (nfolds, mode) reads (edwards_kernel.kernel_table): for nfolds 8
// the fold-8 table in B order (mma_table, 16-byte aligned); for nfolds 4 the
// word table (word_table) in the byte modes, else the packed table
// (packed_table). Launches on `stream`, allocates nothing, does not
// synchronize. Returns cudaGetLastError() (0 on success), the error of a
// refused shared-memory attribute, or -1 for a bad nfolds or mode.
extern "C" int basemult_launch(void* out, const void* cut, const void* zr, int64_t zr_stride,
                               const void* bp, int64_t bp_stride, const void* table,
                               int nfolds, int mode, int64_t n, void* stream) {
  if ((nfolds != 8 && nfolds != 4) || mode < 0 || mode > 3) return -1;
  if (n > 0) {
    if (nfolds == 8) {
      const cudaError_t rc = cudaFuncSetAttribute(
          basemult_fold8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFold8SmemBytes);
      if (rc != cudaSuccess) return (int)rc;
    }
    const bool wide = nfolds == 4 && mode >= MODE_PK;
    auto kernel = nfolds == 8 ? basemult_fold8_kernel
                  : wide      ? basemult_fold4_kernel
                              : basemult_fold4_limbs_kernel;
    const int block = wide ? kFold4Block : kBlock;
    kernel<<<(unsigned)((n + block - 1) / block), block, nfolds == 8 ? kFold8SmemBytes : 0,
             (cudaStream_t)stream>>>((char*)out, (const int32_t*)cut, (const int32_t*)zr,
                                     zr_stride, (const int32_t*)bp, bp_stride,
                                     (const uint32_t*)table, mode, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return code == -1 ? "bad nfolds or mode" : cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// Host entry: the same per-lane code on the CPU, for the tests, over the
// table that the device reads for the same arguments
// (edwards_kernel.kernel_table), or: mma = 0 and nfolds 8, the masked scan
// over the packed fold-8 table (edwards_kernel.packed_table); mma = 1
// (nfolds 8 only), the host emulation of the tensor-core gather over the
// table in B order (edwards_kernel.mma_table), lane i at position i % 32 of
// its warp. Returns 0, or -1 for a bad mma, nfolds or mode.
extern "C" int basemult_host(int mma, void* out, const int32_t* cut, const int32_t* zr,
                             int64_t zr_stride, const int32_t* bp, int64_t bp_stride,
                             const uint32_t* table, int nfolds, int mode, int64_t n) {
  if ((nfolds != 8 && nfolds != 4) || mode < 0 || mode > 3 || (mma && nfolds != 8)) return -1;
  for (int64_t i = 0; i < n; i++) {
    char* o = (char*)out + out_stride(mode) * i;
    const int32_t* z = zr ? zr + zr_stride * i : nullptr;
    const int32_t* b = bp ? bp + bp_stride * i : nullptr;
    if (mma)
      basemult_lane<32>(o, cut + 32 * i, z, b, mode, MmaGatherHost{table, (int)(i & 31)});
    else if (nfolds == 8)
      basemult_lane<32>(o, cut + 32 * i, z, b, mode, ScanGather<256>{table});
    else if (mode >= MODE_PK)
      fold4_wide::lane((uint8_t*)o, cut + 64 * i, z, b, mode == MODE_PK, table);
    else
      basemult_lane<64>(o, cut + 64 * i, z, b, mode, ScanGather<16>{table});
  }
  return 0;
}
