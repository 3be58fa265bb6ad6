// gather_mma.cuh -- the constant-time fold-8 table gather of one warp as an
// exact int8 one-hot product on the tensor cores, emitting each entry as the
// canonical 32-bit words of edwards_kernel.word_table(8).
//
// Replaces, for the sign and keygen kernels and the fold-8 base multiply, a
// masked scan of all 256 entries, as the TPU did the same gather as a one-hot
// product on its matrix unit (curve25519_tpu/ops/pallas/edwards_kernel.py:
// 13-19). The warp's 32 lanes each want entry d(lane) of the 256-entry table:
//
//   D [32 lanes x 96 bytes] = A [32 x 256] . B [256 x 96],
//   A[lane][e] = (e == d(lane)),   B[e][.] = the 96 bytes of entry e,
//
// an entry being ypx, ymx and t2d, each the 8 little-endian words of its
// canonical value. With mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 that
// is 2 m-tiles (lanes 0-15, 16-31) x 8 k-steps (32 entries) x 12 n-tiles (8
// byte columns) = 192 products. Each int32 of D is exactly the chosen byte
// (one 1 in each row of A), so the gather is exact.
//
// Layouts (PTX ISA, "Matrix fragments for mma.m16n8k32", g = lane >> 2,
// t = lane & 3):
//   A, four .b32 of four u8: a0 row g, a1 row g+8, a2 row g, a3 row g+8; a0
//     and a1 hold columns 4t..4t+3, a2 and a3 columns 4t+16..4t+19, the
//     lower column in the lower byte;
//   B, two .b32 of four u8: column g; b0 rows 4t..4t+3, b1 rows 4t+16..4t+19;
//   D, four s32: c0, c1 row g, c2, c3 row g+8; columns 2t and 2t+1.
// The columns of B are ordered so that each thread ends with whole words:
// column 2t + b of n-tile 2k + h is byte 2h + b of word 4k + t of the entry.
// So n-tiles 2k and 2k + 1 give thread (g, t) the four bytes of word 4k + t
// of rows g and g + 8 of each m-tile; it packs them and stages the word in a
// per-warp row of shared memory (stride 28 words: a warp's 32 stores hit 32
// distinct banks, and so do the 16-byte reads of 8 lanes), and each lane
// reads its own 24 words back. The products run a coordinate at a time
// (n-tiles 4c..4c+3, words 8c..8c+7), 2 x 4 accumulators of four s32 live.
// The table is stored in B order (ops/cuda/edwards_kernel.mma_word_table):
// per (k-step, n-tile) the 32 lanes' (b0, b1) word pairs, so a warp reads a
// fragment as 256 contiguous bytes, free of bank conflicts.
//
// Constant time: every warp reads every entry of the table at every gather.
// The digits travel to the threads that hold their rows of A by __shfl_sync
// from a lane that is a function of the thread index; they only select values
// (compare and select), never an address or a branch. Every shared-memory
// address here is a function of the thread index and the loop counters.
//
// mma.sync needs the whole warp converged: the gather starts with
// __syncwarp(), so it may follow per-lane loops of different trip counts, and
// every lane of the warp must call it (a lane with nothing to gather passes
// any digit and ignores the result).
//
// The same layouts are emulated on the host (mma_gather_host), 32 lanes one
// after another, so the CPU tests hold them against the masked scan of the
// word table; HostGather runs the emulation as a lane's words source.

#pragma once

#include <stdint.h>

#ifndef FE_HD
#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif
#define FE_HD __host__ __device__ __forceinline__
#endif

namespace gather_mma {

constexpr int kWords = 24;                               // ypx, ymx, t2d
constexpr int kKSteps = 8;                               // 256 entries / 32
constexpr int kNTiles = 12;                              // 96 bytes / 8
constexpr int kGroup = 4;                                // a coordinate's n-tiles
constexpr int kTableWords = kKSteps * kNTiles * 64;      // 24 KB
constexpr int kStageStride = 28;                         // words per staged lane
constexpr int kStageWords = 32 * kStageStride;           // one warp's staging

// A-operand helpers for the row of digit c seen by thread t: the only nonzero
// A byte of that row lies in register half `key & 1` of k-step `key >> 1`,
// and is `val` (1 in byte c & 3) when thread t holds column c, else 0.
FE_HD void a_row(int32_t c, int t, int32_t& key, uint32_t& val) {
  key = c >> 4;
  val = ((c & 15) >> 2) == t ? 1u << (8 * (c & 3)) : 0u;
}

// The four A registers of one m-tile at k-step ks from its rows g (key0,
// val0) and g+8 (key1, val1). A digit outside 0..255 matches no k-step.
FE_HD void a_frag(uint32_t (&a)[4], int32_t key0, uint32_t val0, int32_t key1, uint32_t val1,
                  int ks) {
  a[0] = key0 == 2 * ks ? val0 : 0u;
  a[1] = key1 == 2 * ks ? val1 : 0u;
  a[2] = key0 == 2 * ks + 1 ? val0 : 0u;
  a[3] = key1 == 2 * ks + 1 ? val1 : 0u;
}

// Word offset of thread `lane`'s (b0, b1) pair for k-step ks, n-tile nt.
FE_HD int b_offset(int ks, int nt, int lane) { return ((ks * kNTiles + nt) * 32 + lane) * 2; }

// Word 4k + t of one row from its D values: lo of n-tile 2k (bytes 0, 1) and
// hi of n-tile 2k + 1 (bytes 2, 3), each byte exact in its int32.
FE_HD uint32_t pack_word(int32_t lo0, int32_t lo1, int32_t hi0, int32_t hi1) {
  return (uint32_t)lo0 | (uint32_t)lo1 << 8 | (uint32_t)hi0 << 16 | (uint32_t)hi1 << 24;
}

// One lane's staged row of 24 words (16-byte aligned) as ypx, ymx, t2d.
FE_HD void unstage(uint32_t (&w)[3][8], const uint32_t* row) {
#ifdef __CUDA_ARCH__
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int q = 0; q < kWords / 4; q++) {
    const uint4 v = r4[q];
    w[q / 2][4 * (q % 2)] = v.x;
    w[q / 2][4 * (q % 2) + 1] = v.y;
    w[q / 2][4 * (q % 2) + 2] = v.z;
    w[q / 2][4 * (q % 2) + 3] = v.w;
  }
#else
  for (int i = 0; i < kWords; i++) w[i / 8][i % 8] = row[i];
#endif
}

#ifdef __CUDACC__

__device__ __forceinline__ void mma_u8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

#endif  // __CUDACC__

// Warp-collective words source: each lane gets the 24 words of entry `idx`.
// frag: the table in B order (kTableWords, shared memory); stage: this
// warp's kStageWords of shared memory.
struct Gather {
  const uint32_t* frag;
  uint32_t* stage;

  FE_HD void operator()(uint32_t (&w)[3][8], int32_t idx) const {
#ifdef __CUDA_ARCH__
    __syncwarp();
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    int32_t key[4];
    uint32_t val[4];
#pragma unroll
    for (int r = 0; r < 4; r++) a_row(__shfl_sync(0xffffffffu, idx, g + 8 * r), t, key[r], val[r]);
#pragma unroll 1
    for (int c = 0; c < 3; c++) {
      int32_t acc[2][kGroup][4];
#pragma unroll
      for (int m = 0; m < 2; m++)
#pragma unroll
        for (int j = 0; j < kGroup; j++)
#pragma unroll
          for (int i = 0; i < 4; i++) acc[m][j][i] = 0;
#pragma unroll 1
      for (int ks = 0; ks < kKSteps; ks++) {
        uint32_t a0[4], a1[4];
        a_frag(a0, key[0], val[0], key[1], val[1], ks);
        a_frag(a1, key[2], val[2], key[3], val[3], ks);
#pragma unroll
        for (int j = 0; j < kGroup; j++) {
          const uint2 b =
              *reinterpret_cast<const uint2*>(frag + b_offset(ks, kGroup * c + j, lane));
          mma_u8(acc[0][j], a0, b.x, b.y);
          mma_u8(acc[1][j], a1, b.x, b.y);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; m++)
#pragma unroll
        for (int p = 0; p < 2; p++) {
          const int word = 8 * c + 4 * p + t;
          const int32_t* lo = acc[m][2 * p];
          const int32_t* hi = acc[m][2 * p + 1];
          stage[(16 * m + g) * kStageStride + word] = pack_word(lo[0], lo[1], hi[0], hi[1]);
          stage[(16 * m + g + 8) * kStageStride + word] = pack_word(lo[2], lo[3], hi[2], hi[3]);
        }
    }
    __syncwarp();
    unstage(w, stage + lane * kStageStride);
#endif
  }
};

#ifdef __CUDACC__

// The table in B order (16-byte aligned) into the block's shared memory
// `smem` (kTableWords, then kStageWords per warp) with 16-byte loads; then
// this thread's Gather over it.
__device__ __forceinline__ Gather load_table(uint32_t* smem, const uint32_t* table) {
  for (int i = threadIdx.x; i < kTableWords / 4; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(table)[i];
  __syncthreads();
  return Gather{smem, smem + kTableWords + (threadIdx.x >> 5) * kStageWords};
}

#endif  // __CUDACC__

// Host emulation of one warp's gather: lanes 0..n-1 (n <= 32) get the 24
// words of entry dig[lane] in out[lane]; lanes n..31 gather digit 0 and are
// not stored. Runs the A, B and D fragment layouts above lane by lane.
inline void mma_gather_host(uint32_t (*out)[kWords], const int32_t* dig, int n,
                            const uint32_t* frag) {
  int32_t d[32];
  uint32_t stage[kStageWords];
  for (int lane = 0; lane < 32; lane++) d[lane] = lane < n ? dig[lane] : 0;
  for (int c = 0; c < 3; c++) {
    int32_t acc[32][2][kGroup][4] = {};
    for (int ks = 0; ks < kKSteps; ks++) {
      uint32_t a[32][2][4];
      for (int lane = 0; lane < 32; lane++) {
        const int g = lane >> 2, t = lane & 3;
        int32_t key[4];
        uint32_t val[4];
        for (int r = 0; r < 4; r++) a_row(d[g + 8 * r], t, key[r], val[r]);
        a_frag(a[lane][0], key[0], val[0], key[1], val[1], ks);
        a_frag(a[lane][1], key[2], val[2], key[3], val[3], ks);
      }
      for (int j = 0; j < kGroup; j++) {
        // the fragments back into matrices: A [2][16][32], B [32][8]
        uint8_t A[2][16][32], B[32][8];
        for (int lane = 0; lane < 32; lane++) {
          const int g = lane >> 2, t = lane & 3;
          const uint32_t* b = frag + b_offset(ks, kGroup * c + j, lane);
          for (int i = 0; i < 4; i++) {
            for (int m = 0; m < 2; m++) {
              A[m][g][4 * t + i] = (uint8_t)(a[lane][m][0] >> (8 * i));
              A[m][g + 8][4 * t + i] = (uint8_t)(a[lane][m][1] >> (8 * i));
              A[m][g][4 * t + 16 + i] = (uint8_t)(a[lane][m][2] >> (8 * i));
              A[m][g + 8][4 * t + 16 + i] = (uint8_t)(a[lane][m][3] >> (8 * i));
            }
            B[4 * t + i][g] = (uint8_t)(b[0] >> (8 * i));
            B[4 * t + 16 + i][g] = (uint8_t)(b[1] >> (8 * i));
          }
        }
        for (int lane = 0; lane < 32; lane++) {
          const int g = lane >> 2, t = lane & 3;
          for (int m = 0; m < 2; m++)
            for (int i = 0; i < 4; i++) {
              const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
              for (int k = 0; k < 32; k++) acc[lane][m][j][i] += A[m][row][k] * B[k][col];
            }
        }
      }
    }
    for (int lane = 0; lane < 32; lane++) {
      const int g = lane >> 2, t = lane & 3;
      for (int m = 0; m < 2; m++)
        for (int p = 0; p < 2; p++) {
          const int word = 8 * c + 4 * p + t;
          const int32_t* lo = acc[lane][m][2 * p];
          const int32_t* hi = acc[lane][m][2 * p + 1];
          stage[(16 * m + g) * kStageStride + word] = pack_word(lo[0], lo[1], hi[0], hi[1]);
          stage[(16 * m + g + 8) * kStageStride + word] = pack_word(lo[2], lo[3], hi[2], hi[3]);
        }
    }
  }
  for (int lane = 0; lane < n; lane++) {
    uint32_t w[3][8];
    unstage(w, stage + lane * kStageStride);
    for (int i = 0; i < kWords; i++) out[lane][i] = w[i / 8][i % 8];
  }
}

// Gather on the host, as the words source of the lane at position `pos` of
// its warp: the lane's digit sits at that position, the other 31 lanes ask
// for other entries (digit + 73 (lane - pos) mod 256), and the warp's gather
// runs through mma_gather_host.
struct HostGather {
  const uint32_t* frag;
  int pos;

  FE_HD void operator()(uint32_t (&w)[3][8], int32_t idx) const {
#ifndef __CUDA_ARCH__
    int32_t dig[32];
    uint32_t rows[32][kWords];
    for (int lane = 0; lane < 32; lane++)
      dig[lane] = lane == pos ? idx : (idx + 73 * (lane - pos)) & 255;
    mma_gather_host(rows, dig, 32, frag);
    for (int i = 0; i < kWords; i++) w[i / 8][i % 8] = rows[pos][i];
#endif
  }
};

}  // namespace gather_mma
