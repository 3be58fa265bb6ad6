// gather_mma.cuh -- the constant-time fold-8 table gather of one warp as an
// exact int8 one-hot product on the tensor cores.
//
// Replaces, for the sign kernel and the fold-8 base multiply, the masked scan
// of edwards25519.cuh (gather<256>), as the TPU did the same gather as a
// one-hot product on its matrix unit
// (curve25519_tpu/ops/pallas/edwards_kernel.py:13-19). The warp's 32 lanes
// each want entry d(lane) of the 256-entry table:
//
//   D [32 lanes x 120 bytes] = A [32 x 256] . B [256 x 120],
//   A[lane][e] = (e == d(lane)),   B[e][2j + h] = byte h of limb j of entry e,
//
// over the 60 limbs ypx ++ ymx ++ t2d of an entry (13 bits each: a low byte
// and a high byte). With mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 that
// is 2 m-tiles (lanes 0-15, 16-31) x 8 k-steps (32 entries) x 15 n-tiles (8
// byte positions, 4 limbs) = 240 products. Each int32 of D is exactly the
// chosen byte (one 1 in each row of A), so the gather is exact.
//
// Layouts (PTX ISA, "Matrix fragments for mma.m16n8k32", g = lane >> 2,
// t = lane & 3):
//   A, four .b32 of four u8: a0 row g, a1 row g+8, a2 row g, a3 row g+8; a0
//     and a1 hold columns 4t..4t+3, a2 and a3 columns 4t+16..4t+19, the
//     lower column in the lower byte;
//   B, two .b32 of four u8: column g; b0 rows 4t..4t+3, b1 rows 4t+16..4t+19;
//   D, four s32: c0, c1 row g, c2, c3 row g+8; columns 2t and 2t+1.
// The table is stored in that B order (ops/cuda/edwards_kernel.mma_table):
// per (k-step, n-tile) the 32 lanes' (b0, b1) word pairs, so a warp reads a
// fragment as 256 contiguous bytes, free of bank conflicts. Column 2t of
// n-tile nt is the low byte of limb 4nt + t, column 2t+1 its high byte, so
// thread (g, t) ends with limb 4nt + t of lanes g and g+8 of each m-tile.
// It stages them in a per-warp row of shared memory (stride 68 words: the
// stores of a warp hit 32 distinct banks, and 16-byte reads of 8 lanes do),
// and each lane reads its own 60 limbs back.
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
// after another, so the CPU tests hold them against gather<256>;
// MmaGatherHost runs the emulation as base_mult's gather policy.

#pragma once

#include "edwards25519.cuh"

namespace ed25519 {

constexpr int kMmaKSteps = 8;                                 // 256 entries / 32
constexpr int kMmaNTiles = 15;                                // 120 bytes / 8
constexpr int kMmaGroup = 5;                                  // n-tiles per D group
constexpr int kMmaTableWords = kMmaKSteps * kMmaNTiles * 64;  // 30 KB
constexpr int kStageStride = 68;                              // words per staged lane
constexpr int kStageWords = 32 * kStageStride;                // one warp's staging

// A-operand helpers for the row of digit c seen by thread t: the only nonzero
// A byte of that row lies in register half `key & 1` of k-step `key >> 1`,
// and is `val` (1 in byte c & 3) when thread t holds column c, else 0.
FE_HD void mma_a_row(int32_t c, int t, int32_t& key, uint32_t& val) {
  key = c >> 4;
  val = ((c & 15) >> 2) == t ? 1u << (8 * (c & 3)) : 0u;
}

// The four A registers of one m-tile at k-step ks from its rows g (key0,
// val0) and g+8 (key1, val1). A digit outside 0..255 matches no k-step.
FE_HD void mma_a_frag(uint32_t (&a)[4], int32_t key0, uint32_t val0, int32_t key1,
                      uint32_t val1, int ks) {
  a[0] = key0 == 2 * ks ? val0 : 0u;
  a[1] = key1 == 2 * ks ? val1 : 0u;
  a[2] = key0 == 2 * ks + 1 ? val0 : 0u;
  a[3] = key1 == 2 * ks + 1 ? val1 : 0u;
}

// Word offset of thread `lane`'s (b0, b1) pair for k-step ks, n-tile nt.
FE_HD int mma_b_offset(int ks, int nt, int lane) { return ((ks * kMmaNTiles + nt) * 32 + lane) * 2; }

// One lane's staged row of 60 limbs (16-byte aligned) as ypx, ymx, t2d.
FE_HD void unstage(Fe& ypx, Fe& ymx, Fe& t2d, const int32_t* row) {
  int32_t limb[3 * NLIMBS];
#ifdef __CUDA_ARCH__
  const int4* r4 = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int q = 0; q < 3 * NLIMBS / 4; q++) {
    const int4 v = r4[q];
    limb[4 * q] = v.x;
    limb[4 * q + 1] = v.y;
    limb[4 * q + 2] = v.z;
    limb[4 * q + 3] = v.w;
  }
#else
  for (int i = 0; i < 3 * NLIMBS; i++) limb[i] = row[i];
#endif
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    ypx.v[i] = limb[i];
    ymx.v[i] = limb[NLIMBS + i];
    t2d.v[i] = limb[2 * NLIMBS + i];
  }
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

// Warp-collective gather: each lane gets entry `idx` of the table. frag: the
// table in B order (kMmaTableWords, shared memory); stage: this warp's
// kStageWords of shared memory.
struct MmaGather {
  const uint32_t* frag;
  int32_t* stage;

  FE_HD void operator()(Fe& ypx, Fe& ymx, Fe& t2d, int32_t idx) const {
#ifdef __CUDA_ARCH__
    __syncwarp();
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    int32_t key[4];
    uint32_t val[4];
#pragma unroll
    for (int r = 0; r < 4; r++) mma_a_row(__shfl_sync(0xffffffffu, idx, g + 8 * r), t, key[r], val[r]);
#pragma unroll 1
    for (int grp = 0; grp < kMmaNTiles / kMmaGroup; grp++) {
      int32_t acc[2][kMmaGroup][4];
#pragma unroll
      for (int m = 0; m < 2; m++)
#pragma unroll
        for (int j = 0; j < kMmaGroup; j++)
#pragma unroll
          for (int c = 0; c < 4; c++) acc[m][j][c] = 0;
#pragma unroll 1
      for (int ks = 0; ks < kMmaKSteps; ks++) {
        uint32_t a0[4], a1[4];
        mma_a_frag(a0, key[0], val[0], key[1], val[1], ks);
        mma_a_frag(a1, key[2], val[2], key[3], val[3], ks);
#pragma unroll
        for (int j = 0; j < kMmaGroup; j++) {
          const uint2 b = *reinterpret_cast<const uint2*>(
              frag + mma_b_offset(ks, grp * kMmaGroup + j, lane));
          mma_u8(acc[0][j], a0, b.x, b.y);
          mma_u8(acc[1][j], a1, b.x, b.y);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; m++)
#pragma unroll
        for (int j = 0; j < kMmaGroup; j++) {
          const int limb = 4 * (grp * kMmaGroup + j) + t;
          stage[(16 * m + g) * kStageStride + limb] = acc[m][j][0] + (acc[m][j][1] << 8);
          stage[(16 * m + g + 8) * kStageStride + limb] = acc[m][j][2] + (acc[m][j][3] << 8);
        }
    }
    __syncwarp();
    unstage(ypx, ymx, t2d, stage + lane * kStageStride);
#endif
  }
};

// The table in B order (16-byte aligned) into the block's shared memory
// `smem` (kMmaTableWords, then kStageWords per warp) with 16-byte loads;
// then this thread's MmaGather over it.
__device__ __forceinline__ MmaGather load_mma_table(uint32_t* smem, const uint32_t* table) {
  for (int i = threadIdx.x; i < kMmaTableWords / 4; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(table)[i];
  __syncthreads();
  return MmaGather{smem, (int32_t*)smem + kMmaTableWords + (threadIdx.x >> 5) * kStageWords};
}

#endif  // __CUDACC__

// Host emulation of one warp's gather: lanes 0..n-1 (n <= 32) get the 60
// limbs of entry dig[lane] in out[lane]; lanes n..31 gather digit 0 and are
// not stored. Runs the A, B and D fragment layouts above lane by lane.
inline void mma_gather_host(int32_t (*out)[3 * NLIMBS], const int32_t* dig, int n,
                            const uint32_t* frag) {
  int32_t d[32], stage[kStageWords];
  for (int lane = 0; lane < 32; lane++) d[lane] = lane < n ? dig[lane] : 0;
  for (int grp = 0; grp < kMmaNTiles / kMmaGroup; grp++) {
    int32_t acc[32][2][kMmaGroup][4] = {};
    for (int ks = 0; ks < kMmaKSteps; ks++) {
      uint32_t a[32][2][4];
      for (int lane = 0; lane < 32; lane++) {
        const int g = lane >> 2, t = lane & 3;
        int32_t key[4];
        uint32_t val[4];
        for (int r = 0; r < 4; r++) mma_a_row(d[g + 8 * r], t, key[r], val[r]);
        mma_a_frag(a[lane][0], key[0], val[0], key[1], val[1], ks);
        mma_a_frag(a[lane][1], key[2], val[2], key[3], val[3], ks);
      }
      for (int j = 0; j < kMmaGroup; j++) {
        // the fragments back into matrices: A [2][16][32], B [32][8]
        uint8_t A[2][16][32], B[32][8];
        for (int lane = 0; lane < 32; lane++) {
          const int g = lane >> 2, t = lane & 3;
          const uint32_t* b = frag + mma_b_offset(ks, grp * kMmaGroup + j, lane);
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
            for (int c = 0; c < 4; c++) {
              const int row = g + 8 * (c >> 1), col = 2 * t + (c & 1);
              for (int k = 0; k < 32; k++) acc[lane][m][j][c] += A[m][row][k] * B[k][col];
            }
        }
      }
    }
    for (int lane = 0; lane < 32; lane++) {
      const int g = lane >> 2, t = lane & 3;
      for (int m = 0; m < 2; m++)
        for (int j = 0; j < kMmaGroup; j++) {
          const int limb = 4 * (grp * kMmaGroup + j) + t;
          const int32_t* c = acc[lane][m][j];
          stage[(16 * m + g) * kStageStride + limb] = c[0] + (c[1] << 8);
          stage[(16 * m + g + 8) * kStageStride + limb] = c[2] + (c[3] << 8);
        }
    }
  }
  for (int lane = 0; lane < n; lane++) {
    Fe ypx, ymx, t2d;
    unstage(ypx, ymx, t2d, stage + lane * kStageStride);
    for (int i = 0; i < NLIMBS; i++) {
      out[lane][i] = ypx.v[i];
      out[lane][NLIMBS + i] = ymx.v[i];
      out[lane][2 * NLIMBS + i] = t2d.v[i];
    }
  }
}

// MmaGather on the host, as a gather policy of base_mult for the lane at
// position `pos` of its warp: the lane's digit sits at that position, the
// other 31 lanes ask for other entries (digit + 73 (lane - pos) mod 256), and
// the warp's gather runs through mma_gather_host.
struct MmaGatherHost {
  const uint32_t* frag;
  int pos;

  FE_HD void operator()(Fe& ypx, Fe& ymx, Fe& t2d, int32_t idx) const {
#ifndef __CUDA_ARCH__
    int32_t dig[32], rows[32][3 * NLIMBS];
    for (int lane = 0; lane < 32; lane++)
      dig[lane] = lane == pos ? idx : (idx + 73 * (lane - pos)) & 255;
    mma_gather_host(rows, dig, 32, frag);
    for (int i = 0; i < NLIMBS; i++) {
      ypx.v[i] = rows[pos][i];
      ymx.v[i] = rows[pos][NLIMBS + i];
      t2d.v[i] = rows[pos][2 * NLIMBS + i];
    }
#endif
  }
};

}  // namespace ed25519
