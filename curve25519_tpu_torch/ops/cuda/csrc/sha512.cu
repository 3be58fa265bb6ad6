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
// What bounds it on this card: int32 ALU issue (~3.7 K 32-bit operations
// per 128-byte block for 80 rounds of 64-bit adds, rotates and logic) for
// short messages; device-memory reads for long ones. The word rows are the
// TPU's layout, one row per lane, so a warp's 32 loads of a word land 32
// rows apart (uncoalesced): a known limit, kept for now; a lane-interleaved
// word layout is later work.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (sha512_launch), and with g++ for the CPU tests
// (sha512_host).

#include "sha512.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

// One lane: digest bytes of the first nblocks blocks of a padded word row
// of nw half-words (a count past the row reads no further than the row).
FE_HD void sha512_lane(uint8_t* out, const int32_t* row, int32_t nblocks, int64_t nw) {
  uint64_t st[8], w[16];
  sha512::init(st);
  const int64_t nb = nblocks < nw / 32 ? nblocks : nw / 32;
#pragma unroll 1
  for (int64_t b = 0; b < nb; b++) {
    sha512::load_block(w, row, b);
    sha512::compress(st, w);
  }
  int32_t md[64];
  sha512::digest_bytes(md, st);
#pragma unroll
  for (int j = 0; j < 64; j++) out[j] = (uint8_t)md[j];
}

#ifdef __CUDACC__

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
sha512_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ words,
              const int32_t* __restrict__ nblocks, int64_t nw, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  sha512_lane(out + 64 * lane, words + nw * lane, nblocks[lane], nw);
}

// out: [n, 64] uint8; words: [n, nw] int32 (nw = 32 x blocks); nblocks: [n]
// int32 active blocks per lane (<= nw / 32). Launches on `stream`,
// allocates nothing, does not synchronize. Returns cudaGetLastError().
extern "C" int sha512_launch(void* out, const void* words, const void* nblocks, int64_t nw,
                             int64_t n, void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);
    sha512_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
        (uint8_t*)out, (const int32_t*)words, (const int32_t*)nblocks, nw, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// Host entry: the same per-lane code on the CPU, for the tests.
extern "C" void sha512_host(uint8_t* out, const int32_t* words, const int32_t* nblocks,
                            int64_t nw, int64_t n) {
  for (int64_t i = 0; i < n; i++) sha512_lane(out + 64 * i, words + nw * i, nblocks[i], nw);
}
