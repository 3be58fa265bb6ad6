// sha512.cu -- batched SHA-512 over padded word blocks, one message per
// thread (CUDA, sm_90a).
//
// Replaces the TPU kernel curve25519_tpu/ops/pallas/sha512_kernel.py
// `_sha_kernel` (launched by `sha512_blocks_tiled`, wrapped by
// `sha512_pallas`). Input: the FIPS 180-4 padded big-endian words of each
// message, one row of nw int32 half-words (hi, lo) per lane, and the lane's
// active block count; output: the 64 digest bytes. The TPU's sequential
// grid axis over chunks of 16 blocks, which carried the state between grid
// steps, becomes a plain loop over the lane's own blocks: a CUDA block has
// no order across the grid. Block counts are public (message lengths).
//
// What bounds it on this card: int32 ALU issue (~4 K instructions per
// 128-byte block for 80 rounds of 64-bit adds, funnel-shift rotates and
// three-input logic) for short messages; for long ones the serial round
// chain of the warp that holds the longest message. Measured on the card
// (PERF.md): the lane-by-lane 64 single-byte stores of each digest,
// 16 lines per store instruction, took three quarters of the time, and the
// uncoalesced word reads next to nothing. So both ends go through shared
// memory:
// - for block b, the warp copies its 32 lanes' 128-byte block rows with
//   16-byte cp.async copies whose addresses run along each row (one
//   instruction moves four whole rows) into a per-warp buffer whose row
//   stride of 36 words keeps the copies and each lane's 16-byte reads of
//   its own row free of bank conflicts; two buffers alternate, so block
//   b + 1 is in flight while b compresses;
// - each lane puts its digest in its row of the first buffer, and the warp
//   stores the 32 digests as 16-byte pieces, 512 contiguous bytes per
//   instruction.
// The warp loops to its longest message (__reduce_max_sync); a lane whose
// own count has run out skips the compression, and a row's block is copied
// only while the row has it. Threads per block do not matter here (32 to
// 128 measured alike, also at 1,024 lanes: one warp per SM sub-partition
// either way), so blocks keep 128.
//
// A warp wholly past n leaves at once; the lanes of a partial warp past n
// take row n - 1 and store nothing, so no row past n is read.
//
// The same library packs the messages: pack_words_kernel writes the padded
// word rows above from the message bytes (see pack_word below).
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (sha512_launch, pack_words_launch), and with g++
// for the CPU tests (sha512_host, which runs the lane code on each row, or
// the warp staging's index arithmetic 32 lanes at a time; pack_words_host,
// which runs the packing's warps on the CPU).

#include "sha512.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

constexpr int kStageStride = 36;               // int32 per staged row: 128 B + 16 B
constexpr int kStageWords = 32 * kStageStride;  // one buffer of a warp

// Active blocks of a row: its count, but no further than the row.
FE_HD int32_t row_blocks(int32_t nblocks, int64_t nw) {
  return nblocks < nw / 32 ? nblocks : (int32_t)(nw / 32);
}

// Thread t of a warp copies, for k = 0..7, the 16 bytes at word
// stage_word(t) of the block row of the warp's lane stage_row(k, t).
FE_HD int stage_row(int k, int t) { return 4 * k + (t >> 3); }
FE_HD int stage_word(int t) { return 4 * (t & 7); }

// The 16 message words of a staged row (kStageStride-strided, 16-byte
// aligned).
FE_HD void load_staged(uint64_t (&w)[16], const int32_t* row) {
#ifdef __CUDA_ARCH__
  const int4* r4 = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int q = 0; q < 8; q++) {
    const int4 v = r4[q];
    w[2 * q] = ((uint64_t)(uint32_t)v.x << 32) | (uint32_t)v.y;
    w[2 * q + 1] = ((uint64_t)(uint32_t)v.z << 32) | (uint32_t)v.w;
  }
#else
  sha512::load_block(w, row, 0);
#endif
}

FE_HD void store_digest(uint8_t* out, const uint64_t (&st)[8]) {
  int32_t md[64];
  sha512::digest_bytes(md, st);
#pragma unroll
  for (int j = 0; j < 64; j++) out[j] = (uint8_t)md[j];
}

FE_HD uint32_t bswap32(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
}

// The digest as 16 little-endian words of its stream bytes (word k: bytes
// 4k..4k+3).
FE_HD void digest_words(uint32_t (&d)[16], const uint64_t (&st)[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    d[2 * i] = bswap32((uint32_t)(st[i] >> 32));
    d[2 * i + 1] = bswap32((uint32_t)st[i]);
  }
}

// The digests leave through the warp's first buffer: each lane puts its 16
// words in its row, then thread t stores, for k = 0..3, 16-byte chunk
// digest_chunk(t) of the digest of lane digest_row(k, t) (each store
// instruction writes 512 contiguous bytes; 8 neighbouring threads read 8
// rows, in distinct banks).
FE_HD int digest_row(int k, int t) { return 8 * k + (t & 7); }
FE_HD int digest_chunk(int t) { return t >> 3; }

// One lane read from its own row: digest bytes of the first nblocks blocks
// of a padded word row of nw half-words.
FE_HD void sha512_lane(uint8_t* out, const int32_t* row, int32_t nblocks, int64_t nw) {
  uint64_t st[8], w[16];
  sha512::init(st);
  const int32_t nb = row_blocks(nblocks, nw);
#pragma unroll 1
  for (int32_t b = 0; b < nb; b++) {
    sha512::load_block(w, row, b);
    sha512::compress(st, w);
  }
  store_digest(out, st);
}

// ---------------------------------------------------------------------------
// Message packing: FIPS 180-4 padding in the word domain, the kernel of
// ops/sha512.pack_words on a card (its plain version is that function's
// PyTorch code). Replaces no TPU kernel: the TPU package packs with XLA ops
// (sha512_kernel._pack_words), which the port first copied as about fifteen
// PyTorch ops, each a pass over the whole batch in int32 or int64.
//
// What bounds it: device memory, one read of the message bytes and one write
// of the words (1,167-byte rows packed to 1,280 bytes). One warp packs a
// row, lane t words t, t + 32, ... (a row is nb x 32 words), so a warp's
// stores are 128 contiguous bytes and its byte loads fall in the same one or
// two lines; rows need no alignment (1,167-byte rows have none). A word
// inside the live message is four unmasked byte loads; the words at the
// edges (the prefix, the last live bytes, the marker, the length) take the
// per-byte path. It runs at 32 registers, so 64 warps fit an SM. Measured
// on the card (PERF.md): variants that loaded two to eight words before
// storing one took 39 or 40 registers and ran 5-53% slower, and one that
// read whole rows without waiting for the length 13-59% slower.
// ---------------------------------------------------------------------------

// Active blocks of a stream of len bytes (floor division, as the plain
// version's int32 //).
FE_HD int32_t pack_nblocks(int32_t len) { return (len + 17 + 127) >> 7; }

// Big-endian word w of a row's padded stream prefix || msg: byte p is
// prefix[p] below P, msg[p - P] below the stream length len (P included;
// msg bytes at or past L read as zero), the 0x80 marker at p == len, else
// zero; the last two words of the last active block hold the 128-bit bit
// length's low half, len >> 29 and len << 3.
FE_HD uint32_t pack_word(const uint8_t* msg, int32_t L, const uint8_t* prefix, int32_t P,
                         int32_t len, int32_t w) {
  const int32_t last = 32 * pack_nblocks(len);
  if (w == last - 2) return (uint32_t)(len >> 29);
  if (w == last - 1) return (uint32_t)len << 3;
  const int32_t lim = len < P + L ? len : P + L;  // stream bytes read from the inputs
  const int32_t p0 = 4 * w;
  if (p0 >= P && p0 + 4 <= lim) {
    const uint8_t* m = msg + (p0 - P);
    return ((uint32_t)m[0] << 24) | ((uint32_t)m[1] << 16) | ((uint32_t)m[2] << 8) | m[3];
  }
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const int32_t p = p0 + k;
    const uint32_t b = p < lim ? (p < P ? prefix[p] : msg[p - P]) : (p == len ? 0x80u : 0u);
    word |= b << (24 - 8 * k);
  }
  return word;
}

// Lane t of the warp that packs one row: words t, t + 32, ... of the row's
// nw, and lane 0 its block count. length counts the message bytes alone.
FE_HD void pack_lane(int32_t* words, int32_t* nblocks, const uint8_t* msg, int32_t L,
                     const uint8_t* prefix, int32_t P, int32_t length, int32_t nw, int t) {
  const int32_t len = length + P;
  for (int32_t w = t; w < nw; w += 32) words[w] = (int32_t)pack_word(msg, L, prefix, P, len, w);
  if (t == 0) *nblocks = pack_nblocks(len);
}

#ifdef __CUDACC__

constexpr int kPackBlock = 256;  // 8 rows a block

// words: [n, nw] int32; nblocks: [n] int32; msg: rows of L bytes, row i at
// msg + i * msg_stride (0 broadcasts one row); prefix: rows of P bytes the
// same way (null when P = 0); length: [n] int32 at length_stride.
__global__ void __launch_bounds__(kPackBlock)
pack_words_kernel(int32_t* __restrict__ words, int32_t* __restrict__ nblocks,
                  const uint8_t* __restrict__ msg, int64_t msg_stride, int32_t L,
                  const uint8_t* __restrict__ prefix, int64_t prefix_stride, int32_t P,
                  const int32_t* __restrict__ length, int64_t length_stride, int32_t nw,
                  int64_t n) {
  const int64_t row = (int64_t)blockIdx.x * (kPackBlock / 32) + (threadIdx.x >> 5);
  if (row >= n) return;
  pack_lane(words + row * nw, nblocks + row, msg + row * msg_stride, L,
            prefix + row * prefix_stride, P, length[row * length_stride], nw, threadIdx.x & 31);
}

// Launches on `stream`, allocates nothing, does not synchronize; every row
// has nw = 32 x blocks words with 4 * nw < 2^31. Returns cudaGetLastError().
extern "C" int pack_words_launch(void* words, void* nblocks, const void* msg, int64_t msg_stride,
                                 int64_t L, const void* prefix, int64_t prefix_stride, int64_t P,
                                 const void* length, int64_t length_stride, int64_t nw, int64_t n,
                                 void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kPackBlock / 32 - 1) / (kPackBlock / 32));
    pack_words_kernel<<<blocks, kPackBlock, 0, (cudaStream_t)stream>>>(
        (int32_t*)words, (int32_t*)nblocks, (const uint8_t*)msg, msg_stride, (int32_t)L,
        (const uint8_t*)prefix, prefix_stride, (int32_t)P, (const int32_t*)length, length_stride,
        (int32_t)nw, n);
  }
  return (int)cudaGetLastError();
}

constexpr int kBlock = 128;
constexpr int kSmemBytes = 4 * 2 * kStageWords * (kBlock / 32);

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Copy block b of the rows of the warp that starts at row `base` into buf:
// rows past n are row n - 1; a row is copied only while it has block b
// (nb: this thread's own count, shuffled to the copying threads).
__device__ __forceinline__ void stage_block(int32_t* buf, const int32_t* words, int64_t nw,
                                            int64_t base, int64_t n, int32_t nb, int b, int t) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const int r = stage_row(k, t);
    const int32_t rnb = __shfl_sync(0xffffffffu, nb, r);
    const int64_t src = base + r < n ? base + r : n - 1;
    if (b < rnb)
      cp_async16(buf + r * kStageStride + stage_word(t), words + src * nw + 32 * b + stage_word(t));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kBlock)
sha512_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ words,
              const int32_t* __restrict__ nblocks, int64_t nw, int64_t n) {
  extern __shared__ __align__(16) int32_t stage[];
  const int t = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  if (base >= n) return;  // the whole warp is past n
  int32_t* buf = stage + (threadIdx.x >> 5) * 2 * kStageWords;
  const int64_t row = base + t < n ? base + t : n - 1;
  const int32_t nb = row_blocks(nblocks[row], nw);
  const int32_t nb_max = __reduce_max_sync(0xffffffffu, nb);

  uint64_t st[8], w[16];
  sha512::init(st);
  if (nb_max > 0) stage_block(buf, words, nw, base, n, nb, 0, t);
#pragma unroll 1
  for (int32_t b = 0; b < nb_max; b++) {
    int32_t* cur = buf + (b & 1) * kStageWords;
    if (b + 1 < nb_max) {
      stage_block(buf + ((b + 1) & 1) * kStageWords, words, nw, base, n, nb, b + 1, t);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();
    if (b < nb) {
      load_staged(w, cur + t * kStageStride);
      sha512::compress(st, w);
    }
    __syncwarp();  // every lane has read `cur` before it is refilled
  }
  uint32_t d[16];
  digest_words(d, st);
  uint4* own = reinterpret_cast<uint4*>(buf + t * kStageStride);
#pragma unroll
  for (int q = 0; q < 4; q++) own[q] = make_uint4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const int r = digest_row(k, t), c = digest_chunk(t);
    if (base + r < n)
      reinterpret_cast<uint4*>(out + 64 * (base + r))[c] =
          reinterpret_cast<const uint4*>(buf + r * kStageStride)[c];
  }
}

// out: [n, 64] uint8; words: [n, nw] int32 (nw = 32 x blocks, 16-byte
// aligned); nblocks: [n] int32 active blocks per lane (a count past the row
// reads no further than the row). Launches on `stream`, allocates nothing,
// does not synchronize. Returns cudaGetLastError().
extern "C" int sha512_launch(void* out, const void* words, const void* nblocks, int64_t nw,
                             int64_t n, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);
    sha512_kernel<<<blocks, kBlock, kSmemBytes, (cudaStream_t)stream>>>(
        (uint8_t*)out, (const int32_t*)words, (const int32_t*)nblocks, nw, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// The kernel's warp on the host: lanes base..base+31 of n, block by block
// through two staging buffers with the kernel's index arithmetic (thread t's
// copies, then each lane's read of its own staged row).
static void sha512_warp_host(uint8_t* out, const int32_t* words, const int32_t* nblocks,
                             int64_t nw, int64_t n, int64_t base) {
  int32_t buf[2][kStageWords];
  int32_t nb[32], nb_max = 0;
  uint64_t st[32][8], w[16];
  for (int t = 0; t < 32; t++) {
    nb[t] = row_blocks(nblocks[base + t < n ? base + t : n - 1], nw);
    nb_max = nb[t] > nb_max ? nb[t] : nb_max;
    sha512::init(st[t]);
  }
  for (int32_t b = 0; b < nb_max; b++) {
    int32_t* cur = buf[b & 1];
    for (int t = 0; t < 32; t++)
      for (int k = 0; k < 8; k++) {
        const int r = stage_row(k, t);
        const int64_t src = base + r < n ? base + r : n - 1;
        if (b < nb[r])
          for (int i = 0; i < 4; i++)
            cur[r * kStageStride + stage_word(t) + i] = words[src * nw + 32 * b + stage_word(t) + i];
      }
    for (int t = 0; t < 32; t++)
      if (b < nb[t]) {
        load_staged(w, cur + t * kStageStride);
        sha512::compress(st[t], w);
      }
  }
  for (int t = 0; t < 32; t++) {
    uint32_t d[16];
    digest_words(d, st[t]);
    for (int i = 0; i < 16; i++) buf[0][t * kStageStride + i] = (int32_t)d[i];
  }
  for (int t = 0; t < 32; t++)
    for (int k = 0; k < 4; k++) {
      const int r = digest_row(k, t), c = digest_chunk(t);
      if (base + r < n)
        for (int i = 0; i < 16; i++)  // little-endian words, as on the card
          out[64 * (base + r) + 16 * c + i] =
              (uint8_t)((uint32_t)buf[0][r * kStageStride + 4 * c + i / 4] >> (8 * (i % 4)));
    }
}

// Host entry: the same code on the CPU, for the tests. staged = 0: each
// lane from its own row (sha512_lane); staged = 1: the kernel's warp
// staging, 32 lanes at a time, the last warp partial.
extern "C" void sha512_host(int staged, uint8_t* out, const int32_t* words,
                            const int32_t* nblocks, int64_t nw, int64_t n) {
  if (staged) {
    for (int64_t base = 0; base < n; base += 32) sha512_warp_host(out, words, nblocks, nw, n, base);
    return;
  }
  for (int64_t i = 0; i < n; i++) sha512_lane(out + 64 * i, words + nw * i, nblocks[i], nw);
}

// Host entry of the packing: the kernel's warps on the CPU, row after row and
// lane after lane, with the kernel's arguments.
extern "C" void pack_words_host(int32_t* words, int32_t* nblocks, const uint8_t* msg,
                                int64_t msg_stride, int64_t L, const uint8_t* prefix,
                                int64_t prefix_stride, int64_t P, const int32_t* length,
                                int64_t length_stride, int64_t nw, int64_t n) {
  for (int64_t row = 0; row < n; row++)
    for (int t = 0; t < 32; t++)
      pack_lane(words + row * nw, nblocks + row, msg + row * msg_stride, (int32_t)L,
                prefix + row * prefix_stride, (int32_t)P, length[row * length_stride],
                (int32_t)nw, t);
}
