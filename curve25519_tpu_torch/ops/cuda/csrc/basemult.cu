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
// lane and the grid masks lane < n. Four kernels:
//
// basemult_fold8_kernel (the byte modes, the API's fast public key) and
// basemult_fold4_kernel (the same with nfolds=4). What bounds them: the FMA
// pipe's field products, 31 x (4 M + 4 S + 7 M) for fold 8 and 63 x for
// fold 4, and the inversion: ~730 and ~1,200 multiplies and squarings a
// lane. So both run the lane of fold_wide.cuh on the wide core,
// fe25519_wide.cuh (a multiply is 100 `IMAD.WIDE.U32` against the 13-bit
// core's ~420 IMAD), through the point formulas of edwards25519_wide.cuh;
// the bytes depend only on the point, not on its limbs. Each table entry
// is read as the 8 little-endian words of each of its canonical
// coordinates (edwards_kernel.word_table), in constant time:
// - fold 8's 32 reads of 256 entries on the tensor cores
//   (gather_mma.cuh): per warp and read, 192 int8 one-hot mma.sync
//   products over the table in shared memory, in B-fragment order, where a
//   masked scan of all 256 entries costs ~6 K ALU operations per lane and
//   read, about as much as the step's arithmetic. No address and no branch
//   depends on a digit. mma.sync needs the whole warp: a warp wholly past n
//   leaves at once, the lanes of a partial warp recompute lane n - 1 and
//   store nothing. Shared memory per block: the 24 KB table and a staging
//   row per warp (3.5 KB), dynamic;
// - fold 4's 64 reads of 16 entries by a masked scan (1.5 KB in shared
//   memory, broadcast 16-byte reads, two entries a loop trip): 384 LOP3 a
//   read, on the ALU pipe, which the field work leaves about two thirds
//   idle (PERF.md section 6). 256 threads a block, at most 128 registers a
//   thread: 16 warps per SM.
// zr and BP arrive as 13-bit limbs and are converted once per lane
// (weak_limbs.cuh), BP a coordinate at a time just before the multiply that
// takes it.
//
// basemult_fold8_limbs_kernel and basemult_fold4_limbs_kernel (affine,
// mont_u): the 13-bit lane of edwards25519.cuh. These modes emit the plain
// version's weak 13-bit limbs, which only the same radix and the same ops
// reproduce. Fold 8 reads the same table through the same tensor-core
// gather as its byte modes and takes the gathered canonical words to the
// table's canonical 13-bit limbs; fold 4 scans its packed table (two limbs a
// word).
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (basemult_launch), and with g++ for the CPU
// tests (basemult_host), which run the same per-lane code on the host, the
// fold-8 reads by the masked scan or by the host emulation of the tensor-core
// gather.

#include "fold_wide.cuh"
#include "gather_mma.cuh"
#include "edwards25519.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

using namespace ed25519;

enum Mode { MODE_AFFINE = 0, MODE_MONT_U = 1, MODE_PK = 2, MODE_U_BYTES = 3 };

// A words source (gather_mma's, or on the host the masked scan of the word
// table) as the 13-bit lane's gather: the gathered canonical words as the
// table's canonical 13-bit limbs.
template <class Words>
struct Limbs13Gather {
  Words words;

  FE_HD void operator()(Fe& ypx, Fe& ymx, Fe& t2d, int32_t idx) const {
    uint32_t w[3][8];
    words(w, idx);
    fe_wide::limbs13_from_words(ypx.v, w[0]);
    fe_wide::limbs13_from_words(ymx.v, w[1]);
    fe_wide::limbs13_from_words(t2d.v, w[2]);
  }
};

// One lane of the limb modes. zr: 20 limbs or null for one; bp: 80 limbs
// (ypx, ymx, t2d, z2) or null; out: 40 int32 limbs, or null to store
// nothing; gather: a constant-time gather policy of base_mult over the table
// of the NCUTS digits.
template <int NCUTS, class Gather>
FE_HD void limbs_lane(int32_t* out, const int32_t* cut, const int32_t* zr, const int32_t* bp,
                      int mode, const Gather& gather) {
  const Fe z0 = zr ? load_fe(zr) : one();
  Ext s = base_mult<NCUTS>(cut, z0, gather);
  if (!out) return;
  if (bp) s = add_pe(s, bp);
  // one inversion: of Z for affine, of Z - Y for u
  const bool is_u = mode == MODE_MONT_U;
  const Fe di = inv(is_u ? sub(s.z, s.y) : s.z);
  const Fe a = is_u ? mul(add(s.z, s.y), di) : mul(s.x, di);
  const Fe b = is_u ? a : mul(s.y, di);
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    out[i] = a.v[i];
    out[NLIMBS + i] = b.v[i];
  }
}

FE_HD int64_t out_stride(int mode) { return mode >= MODE_PK ? 32 : 4 * 2 * NLIMBS; }

#ifdef __CUDACC__

// The fold-8 byte modes' block size and minimum of blocks per SM (PERF.md
// section 6 lists each shape tried).
constexpr int kFold8Block = 128;
constexpr int kFold8MinBlocks = 3;
constexpr int kBlock = 128;  // the limb modes'

// Dynamic shared memory of the fold-8 kernels: the table in B order, then
// one staging row per warp.
constexpr int fold8_smem_bytes(int block) {
  return 4 * (gather_mma::kTableWords + (block / 32) * gather_mma::kStageWords);
}

__global__ void __launch_bounds__(kFold8Block, kFold8MinBlocks)
basemult_fold8_kernel(char* out, const int32_t* __restrict__ cut, const int32_t* __restrict__ zr,
                      int64_t zr_stride, const int32_t* __restrict__ bp, int64_t bp_stride,
                      const uint32_t* __restrict__ table, int mode, int64_t n) {
  extern __shared__ __align__(16) uint32_t smem[];
  const gather_mma::Gather gather = gather_mma::load_table(smem, table);
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~(int64_t)31) >= n) return;  // the whole warp is past n
  const int64_t row = lane < n ? lane : n - 1;
  const fold_wide::Ext s =
      fold_wide::base_mult<32>(cut + 32 * row, zr ? zr + zr_stride * row : nullptr,
                               bp ? bp + bp_stride * row : nullptr, gather);
  if (lane < n) fold_wide::epilogue((uint8_t*)out + 32 * lane, s, mode == MODE_PK);
}

// The limb modes of fold 8 on the 13-bit lane, through the same gather.
__global__ void __launch_bounds__(kBlock)
basemult_fold8_limbs_kernel(char* out, const int32_t* __restrict__ cut,
                            const int32_t* __restrict__ zr, int64_t zr_stride,
                            const int32_t* __restrict__ bp, int64_t bp_stride,
                            const uint32_t* __restrict__ table, int mode, int64_t n) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Limbs13Gather<gather_mma::Gather> gather{gather_mma::load_table(smem, table)};
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~(int64_t)31) >= n) return;  // the whole warp is past n
  const int64_t row = lane < n ? lane : n - 1;
  limbs_lane<32>(lane < n ? (int32_t*)(out + out_stride(mode) * lane) : nullptr, cut + 32 * row,
                 zr ? zr + zr_stride * row : nullptr, bp ? bp + bp_stride * row : nullptr, mode,
                 gather);
}

// The byte modes on the wide lane, 256 threads a block. At most 128
// registers a thread: two blocks, 16 warps, per SM (PERF.md section 6
// lists the other shapes tried).
constexpr int kFold4Block = 256;

__global__ void __launch_bounds__(kFold4Block, 2)
basemult_fold4_kernel(char* out, const int32_t* __restrict__ cut, const int32_t* __restrict__ zr,
                      int64_t zr_stride, const int32_t* __restrict__ bp, int64_t bp_stride,
                      const uint32_t* __restrict__ table, int mode, int64_t n) {
  constexpr int kTableWords = 16 * fold_wide::kWords;
  __shared__ __align__(16) uint32_t tbl[kTableWords];
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  fold_wide::lane<64>((uint8_t*)out + 32 * lane, cut + 64 * lane,
                      zr ? zr + zr_stride * lane : nullptr, bp ? bp + bp_stride * lane : nullptr,
                      mode == MODE_PK, fold_wide::ScanWords<16>{tbl});
}

// The limb modes of fold 4 on the 13-bit lane.
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
  limbs_lane<64>((int32_t*)(out + out_stride(mode) * lane), cut + 64 * lane,
                 zr ? zr + zr_stride * lane : nullptr, bp ? bp + bp_stride * lane : nullptr,
                 mode, ScanGather<16>{tbl});
}

// out: [n, 32] uint8 or [n, 40] int32 (by mode); cut: [n, 256/nfolds] int32;
// zr: [n, 20] int32 rows at zr_stride (0: one shared row) or null; bp: [n, 80]
// int32 rows at bp_stride or null; table, on the device, the one that the
// launch of (nfolds, mode) reads (edwards_kernel.kernel_table): for nfolds 8
// the word table in B order (mma_word_table, 16-byte aligned); for nfolds 4
// the word table (word_table) in the byte modes, else the packed table
// (packed_table). Launches on `stream`, allocates nothing, does not
// synchronize. Returns cudaGetLastError() (0 on success), the error of a
// refused shared-memory attribute, or -1 for a bad nfolds or mode.
extern "C" int basemult_launch(void* out, const void* cut, const void* zr, int64_t zr_stride,
                               const void* bp, int64_t bp_stride, const void* table,
                               int nfolds, int mode, int64_t n, void* stream) {
  if ((nfolds != 8 && nfolds != 4) || mode < 0 || mode > 3) return -1;
  if (n > 0) {
    const bool bytes = mode >= MODE_PK;
    auto kernel = nfolds == 8 ? (bytes ? basemult_fold8_kernel : basemult_fold8_limbs_kernel)
                              : (bytes ? basemult_fold4_kernel : basemult_fold4_limbs_kernel);
    const int block = nfolds == 8 && bytes ? kFold8Block : bytes ? kFold4Block : kBlock;
    const int smem = nfolds == 8 ? fold8_smem_bytes(block) : 0;
    if (smem) {
      const cudaError_t rc =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return (int)rc;
    }
    kernel<<<(unsigned)((n + block - 1) / block), block, smem, (cudaStream_t)stream>>>(
        (char*)out, (const int32_t*)cut, (const int32_t*)zr, zr_stride, (const int32_t*)bp,
        bp_stride, (const uint32_t*)table, mode, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return code == -1 ? "bad nfolds or mode" : cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// Host entry: the same per-lane code on the CPU, for the tests, over the
// table that the device reads for the same arguments
// (edwards_kernel.kernel_table), or, for nfolds 8: mma = 0, the masked scan
// of the word table (edwards_kernel.word_table(8)); mma = 1, the host
// emulation of the tensor-core gather over the word table in B order
// (edwards_kernel.mma_word_table), lane i at position i % 32 of its warp.
// Returns 0, or -1 for a bad mma, nfolds or mode.
extern "C" int basemult_host(int mma, void* out, const int32_t* cut, const int32_t* zr,
                             int64_t zr_stride, const int32_t* bp, int64_t bp_stride,
                             const uint32_t* table, int nfolds, int mode, int64_t n) {
  if ((nfolds != 8 && nfolds != 4) || mode < 0 || mode > 3 || (mma && nfolds != 8)) return -1;
  const bool bytes = mode >= MODE_PK;
  for (int64_t i = 0; i < n; i++) {
    char* o = (char*)out + out_stride(mode) * i;
    const int32_t* z = zr ? zr + zr_stride * i : nullptr;
    const int32_t* b = bp ? bp + bp_stride * i : nullptr;
    const gather_mma::HostGather tc{table, (int)(i & 31)};
    const fold_wide::ScanWords<256> scan{table};
    if (nfolds == 4 && bytes)
      fold_wide::lane<64>((uint8_t*)o, cut + 64 * i, z, b, mode == MODE_PK,
                          fold_wide::ScanWords<16>{table});
    else if (nfolds == 4)
      limbs_lane<64>((int32_t*)o, cut + 64 * i, z, b, mode, ScanGather<16>{table});
    else if (bytes && mma)
      fold_wide::lane<32>((uint8_t*)o, cut + 32 * i, z, b, mode == MODE_PK, tc);
    else if (bytes)
      fold_wide::lane<32>((uint8_t*)o, cut + 32 * i, z, b, mode == MODE_PK, scan);
    else if (mma)
      limbs_lane<32>((int32_t*)o, cut + 32 * i, z, b, mode, Limbs13Gather<decltype(tc)>{tc});
    else
      limbs_lane<32>((int32_t*)o, cut + 32 * i, z, b, mode, Limbs13Gather<decltype(scan)>{scan});
  }
  return 0;
}
