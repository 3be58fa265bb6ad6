// digits.cu -- Ed25519 verify's fold digits, one lane per thread (CUDA,
// sm_90a).
//
// Replaces no TPU kernel: the JAX package computes these digits with XLA
// ops between its SHA-512 kernel and its verify kernels
// (curve25519_tpu/models/ed25519.py verify and verify_check:
// sc.from_digest, fold.cut8_bytes, fold.cut4_limbs), which the port first
// ran as about 260 small PyTorch launches a call. digits_kernel does that
// work in one launch. Per lane it
// - reduces the 64-byte digest of R || A || M mod l (sc25519.cuh's
//   from_digest) and writes the 64 4-fold digits of h in the convention of
//   ops/fold.cut4: v[c] from the odd words, v[32 + c] from the even words;
// - writes the 32 8-fold digits of S's 32 raw bytes (ops/fold.cut8, as
//   fold_wide::CombDigits reads them). S is never reduced: whether S >= l
//   is accepted is the verdict's to decide (strict).
// The plain version is those three PyTorch calls (models/ed25519._digits
// on the CPU).
//
// What bounds it on this card: device memory. A lane reads 96 bytes (the
// digest and S) and writes 384 (u [n, 32] and v [n, 64] int32): 480 bytes,
// 0.038 ms for 262,144 lanes at 3.35 TB/s. The reduction (one reduce40,
// about 400 IMAD and three carry chains) and the 512 bit extractions are a
// few thousand instructions a lane, below that. What the design does
// about it: a thread reads its lane's two rows with 16-byte loads where the
// rows and strides allow (the digests of sha512_kernel, and S inside
// 64-byte signature rows, do; other rows are read a byte at a time) and
// builds every digit in registers, four to a word, into a tile of its
// block's 128 lanes in shared memory (13 KB); the block then writes the
// tile's u and v rows, contiguous in device memory, as coalesced 16-byte
// stores, consecutive threads on consecutive addresses. Measured on the
// card (PERF.md): 0.052 ms at 262,144 lanes, 72% of the bound; a thread
// writing its own rows (16-byte stores 128 and 256 bytes apart across a
// warp) ran at 17%. Rows are read at any stride, so S is read in place
// from the signatures, and a stride of 0 broadcasts one row.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (digits_launch), and with g++ for the CPU tests
// (digits_host), which run the same lane and tile code on the host, a block
// at a time.

#include "fold_wide.cuh"
#include "sc25519.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

// NW little-endian words of a row of 4 * NW bytes: 16-byte loads on the
// device when vec (the row 16-byte aligned), else a byte at a time.
template <int NW>
FE_HD void load_row(uint32_t (&w)[NW], const uint8_t* row, bool vec) {
#ifdef __CUDA_ARCH__
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int q = 0; q < NW / 4; q++) {
      const uint4 x = r4[q];
      w[4 * q] = x.x;
      w[4 * q + 1] = x.y;
      w[4 * q + 2] = x.z;
      w[4 * q + 3] = x.w;
    }
    return;
  }
#endif
#pragma unroll
  for (int k = 0; k < NW; k++)
    w[k] = (uint32_t)row[4 * k] | ((uint32_t)row[4 * k + 1] << 8) |
           ((uint32_t)row[4 * k + 2] << 16) | ((uint32_t)row[4 * k + 3] << 24);
}

// The 4-fold digits of a scalar's 8 little-endian words (ops/fold.cut4):
// bit m of digit c < 32 is bit 31 - c of odd word 2m + 1, bit m of digit
// 32 + c is bit 31 - c of even word 2m.
struct Cut4Digits {
  uint32_t w[8];

  FE_HD int32_t operator[](int c) const {
    const int odd = c < 32;
    const int s = 31 - (c & 31);
    int32_t d = 0;
#pragma unroll
    for (int m = 0; m < 4; m++) d |= (int32_t)((w[2 * m + odd] >> s) & 1) << m;
    return d;
  }
};

constexpr int kBlock = 128;
// A lane's digits packed four to a word (each digit < 256, little-endian),
// and the row stride of a block's tile of them in shared memory: odd, so
// that the lanes' rows fall in distinct banks.
constexpr int kUWords = 8, kUStride = kUWords + 1;
constexpr int kVWords = 16, kVStride = kVWords + 1;

// Words k = 0..NW-1 of digits d, four each.
template <int NW, class Digits>
FE_HD void pack_digits(uint32_t* row, const Digits& d) {
#pragma unroll
  for (int k = 0; k < NW; k++)
    row[k] = (uint32_t)d[4 * k] | ((uint32_t)d[4 * k + 1] << 8) | ((uint32_t)d[4 * k + 2] << 16) |
             ((uint32_t)d[4 * k + 3] << 24);
}

// One lane into row t of the block's tiles: su the 8-fold digits of S, sv
// the 4-fold digits of md mod l; md and s: the lane's 64 and 32 bytes.
FE_HD void stage_lane(uint32_t* su, uint32_t* sv, int t, const uint8_t* md, const uint8_t* s,
                      bool vec) {
  uint32_t w[16];
  load_row(w, md, vec);
  int32_t by[64];
#pragma unroll
  for (int j = 0; j < 64; j++) by[j] = (int32_t)((w[j / 4] >> (8 * (j % 4))) & 0xFF);
  const fe25519::Fe h = sc25519::from_digest(by);
  Cut4Digits hd;
  fe_wide::words_from_limbs13(hd.w, h.v);
  pack_digits<kVWords>(sv + t * kVStride, hd);
  fold_wide::CombDigits sd;
  load_row(sd.w, s, vec);
  pack_digits<kUWords>(su + t * kUStride, sd);
}

// Thread t's share of writing the first `rows` rows of a tile of packed
// digits (NW words a row, at stride ST) to out as int32 rows of 4 * NW:
// one word, four digits, 16 bytes, a step, so consecutive threads write
// consecutive 16 bytes of out (16-byte aligned).
template <int NW, int ST>
FE_HD void store_tile(int32_t* out, const uint32_t* tile, int rows, int t) {
  for (int i = t; i < rows * NW; i += kBlock) {
    const uint32_t x = tile[(i / NW) * ST + i % NW];
#ifdef __CUDA_ARCH__
    reinterpret_cast<int4*>(out)[i] = make_int4(x & 0xFF, (x >> 8) & 0xFF, (x >> 16) & 0xFF, x >> 24);
#else
    for (int b = 0; b < 4; b++) out[4 * i + b] = (int32_t)((x >> (8 * b)) & 0xFF);
#endif
  }
}

#ifdef __CUDACC__

// A block of kBlock lanes: each thread stages its lane's digits in shared
// memory, then the block writes the tile's u and v rows, which are
// contiguous in device memory, with coalesced 16-byte stores.
__global__ void __launch_bounds__(kBlock)
digits_kernel(int32_t* __restrict__ u, int32_t* __restrict__ v, const uint8_t* __restrict__ md,
              int64_t md_stride, const uint8_t* __restrict__ s, int64_t s_stride, int64_t n,
              bool vec) {
  __shared__ uint32_t su[kBlock * kUStride], sv[kBlock * kVStride];
  const int64_t base = (int64_t)blockIdx.x * kBlock;
  const int t = threadIdx.x;
  if (base + t < n)
    stage_lane(su, sv, t, md + (base + t) * md_stride, s + (base + t) * s_stride, vec);
  __syncthreads();
  const int rows = n - base < kBlock ? (int)(n - base) : kBlock;
  store_tile<kUWords, kUStride>(u + 32 * base, su, rows, t);
  store_tile<kVWords, kVStride>(v + 64 * base, sv, rows, t);
}

// u: [n, 32] and v: [n, 64] int32 out, 16-byte aligned; md: n rows of 64
// bytes at md_stride, s: n rows of 32 bytes at s_stride (strides in bytes,
// 0 for one row broadcast). Rows and strides that are all multiples of 16
// take 16-byte loads. Launches on `stream`, allocates nothing, does not
// synchronize and returns cudaGetLastError() (0 on success).
extern "C" int digits_launch(void* u, void* v, const void* md, int64_t md_stride, const void* s,
                             int64_t s_stride, int64_t n, void* stream) {
  if (n > 0) {
    const bool vec =
        (((uintptr_t)md | (uintptr_t)s | (uint64_t)md_stride | (uint64_t)s_stride) & 15) == 0;
    digits_kernel<<<(unsigned)((n + kBlock - 1) / kBlock), kBlock, 0, (cudaStream_t)stream>>>(
        (int32_t*)u, (int32_t*)v, (const uint8_t*)md, md_stride, (const uint8_t*)s, s_stride, n,
        vec);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// Host entry: the kernel's blocks on the CPU, for the tests: each lane of a
// block staged, then each thread's share of the block's stores.
extern "C" void digits_host(int32_t* u, int32_t* v, const uint8_t* md, int64_t md_stride,
                            const uint8_t* s, int64_t s_stride, int64_t n) {
  uint32_t su[kBlock * kUStride], sv[kBlock * kVStride];
  for (int64_t base = 0; base < n; base += kBlock) {
    const int rows = n - base < kBlock ? (int)(n - base) : kBlock;
    for (int t = 0; t < rows; t++)
      stage_lane(su, sv, t, md + (base + t) * md_stride, s + (base + t) * s_stride, false);
    for (int t = 0; t < kBlock; t++) {
      store_tile<kUWords, kUStride>(u + 32 * base, su, rows, t);
      store_tile<kVWords, kVStride>(v + 64 * base, sv, rows, t);
    }
  }
}
