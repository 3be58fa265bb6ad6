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
// 512 threads per SM, persistent, runs the same number of rounds as every
// other block, and all its warps meet at a barrier after each round's
// Verify_Init: an SM runs one phase's code at a time but for the short turn
// from a round's multiply to the next round's Verify_Init (a second barrier
// there cost 1%). The scratch holds the resident lanes only: one row per
// thread of the grid. The fold-8 word table is copied once per block into
// shared memory and read by index.
//
// The lane split (split_lane) balances the SMs and their schedulers: the n
// lanes are cut into ceil(n / 32) groups of 32 consecutive lanes, each block
// takes floor or ceil of groups / grid consecutive groups, and spreads them
// over the rounds in quads of 4 warps, one on each scheduler. A split in
// 512-lane tiles would leave the SMs of a last, partial wave idle: at
// 165,000 lanes on 132 SMs the busiest SM ran 3 rounds of 16 warps (4 a
// scheduler) against a mean of 39.1 warps; balanced it runs 16, 12 and 12.
// A thread with no group in a round, or whose lane is past n, skips both
// phases but still reaches the barrier.
//
// The library owns the launch shape: oneshot_scratch_rows gives the scratch
// rows (grid x block) for n lanes, and oneshot_launch takes the grid from the
// rows it is given, so the kernel never indexes past the scratch;
// oneshot_busiest_warps gives the warps of the busiest block.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (oneshot_scratch_rows, oneshot_busiest_warps,
// oneshot_launch), and with g++ for the CPU tests (oneshot_host, which runs
// the same per-lane code and scratch layout on the host, and
// oneshot_split_host, the lanes of every round, block and thread).

#include "verify_lane.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

constexpr int kOneshotBlock = 512;
constexpr int kOneshotWarps = kOneshotBlock / 32;

// Scratch rows of the launch for n lanes on a card of `sms` SMs: one block
// per SM at most, each of kOneshotBlock threads (a row each).
extern "C" int oneshot_scratch_rows(int64_t n, int sms) {
  const int64_t blocks = (n + kOneshotBlock - 1) / kOneshotBlock;
  return (int)(blocks < sms ? blocks : sms) * kOneshotBlock;
}

// Warps of the busiest block of `grid` for n lanes: ceil(ceil(n / 32) / grid).
FE_HD int64_t split_busiest(int64_t n, int64_t grid) {
  return ((n + 31) / 32 + grid - 1) / grid;
}

// Rounds of every block: the busiest block's warps, kOneshotWarps a round.
// Equal to ceil(ceil(n / 512) / grid), the tiles of a block in 512-lane tiles.
FE_HD int64_t split_rounds(int64_t n, int64_t grid) {
  return (split_busiest(n, grid) + kOneshotWarps - 1) / kOneshotWarps;
}

// The lane of `thread` of `block` in `round` for n lanes over `grid` blocks,
// or -1 for none. Block b takes the groups of 32 lanes [first, first + count)
// with count = groups / grid, one more for the first groups % grid blocks,
// and hands them to its rounds in quads of 4 groups, in order, a warp a
// group: quads / rounds quads a round, one more for the first
// quads % rounds rounds. Warp w of a block runs on the SM's scheduler w % 4,
// and a round lasts as long as its busiest scheduler's warps, so a round of
// whole quads keeps the 4 schedulers level.
FE_HD int64_t split_lane(int64_t n, int64_t grid, int64_t block, int64_t round,
                         int thread) {
  const int64_t groups = (n + 31) / 32, rounds = split_rounds(n, grid);
  const int64_t q = groups / grid, r = groups % grid;
  const int64_t count = q + (block < r), first = block * q + (block < r ? block : r);
  const int64_t quads = (count + 3) / 4, q2 = quads / rounds, r2 = quads % rounds;
  const int warp = thread / 32;
  const int64_t group = 4 * (round * q2 + (round < r2 ? round : r2)) + warp;
  if (warp >= 4 * (q2 + (round < r2)) || group >= count) return -1;
  const int64_t lane = 32 * (first + group) + thread % 32;
  return lane < n ? lane : -1;
}

extern "C" int oneshot_busiest_warps(int64_t n, int64_t grid) {
  return grid > 0 ? (int)split_busiest(n, grid) : 0;
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
  const int rounds = (int)split_rounds(n, gridDim.x);
#pragma unroll 1
  for (int round = 0; round < rounds; round++) {
    const int64_t lane = split_lane(n, gridDim.x, blockIdx.x, round, threadIdx.x);
    if (lane >= 0) verify_init_lane(row, ok + lane, pk + 32 * lane);
    __syncthreads();
    if (lane >= 0) poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, row, tbl);
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

// Host entry: the kernel's lane split for the tests. Returns the rounds of
// n lanes over `grid` blocks and, unless lanes is null, fills lanes:
// [rounds, grid, kOneshotBlock] int64, each thread's lane in each round, or -1.
extern "C" int64_t oneshot_split_host(int64_t* lanes, int64_t n, int64_t grid) {
  const int64_t rounds = split_rounds(n, grid);
  for (int64_t k = 0; lanes && k < rounds; k++)
    for (int64_t b = 0; b < grid; b++)
      for (int t = 0; t < kOneshotBlock; t++)
        lanes[(k * grid + b) * kOneshotBlock + t] = split_lane(n, grid, b, k, t);
  return rounds;
}
