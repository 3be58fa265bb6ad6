// poly.cu -- the Ed25519 double-scalar multiply enc(s*G + h*(-Q)), one lane
// per thread (CUDA, sm_90a).
//
// Replaces the TPU kernel curve25519_tpu/ops/pallas/verify_kernel.py
// `_poly_kernel` in both of its launchers: poly_mult_tiled -> poly_kernel (a
// q_table per lane) and poly_mult_tiled_shared -> poly_shared_kernel (one
// q_table for every lane). The lane code is poly_lane of verify_lane.cuh,
// which the fused one-shot kernel (oneshot.cu) runs too; the q_tables are the
// verify context's int8 planes, [16, 160] bytes per table, as
// verify_init_kernel (verify.cu) writes them and the JAX context holds them.
// Where the TPU padded to 1024-lane tiles, each thread owns one lane and the
// grid masks lane < n.
//
// What bounds it on this card: the field products, ~990 multiplies and
// ~510 squarings per lane with the inversion; the bytes (the 2.5 KB table
// per lane, read in parts) are far below. What the design does about it:
// the lane runs on the wide field core, fe25519_wide.cuh (ten 32-bit limbs
// in radix 2^25.5, a multiply 100 `IMAD.WIDE.U32`), with the point formulas
// of edwards25519_wide.cuh, as Verify_Init does. The 13-bit radix stays only
// where an entry is read: each coordinate of a PE add's entry (5 words of
// each plane, four 16-byte loads) is decoded and converted to wide limbs
// just before the multiply that takes it (PlaneEntry), so at most one
// coordinate of the entry is live beside the point. Both loops of the
// multiply are one rolled loop, so the code of a double and a PE add
// appears once. At most 168 registers a thread under
// __launch_bounds__(128, 3): three blocks, 12 warps, per SM. The lane fits
// 128 registers with no spill too, but at 16 warps per SM it ran 5% slower
// (PERF.md section 6).
// The base table of s, edwards_kernel.word_table(8) (24 KB), is copied once
// per block into shared memory and read by index; poly_shared_kernel copies
// its one q_table there too.
//
// poly_keyed_kernel serves lanes whose keys come from a known set: the
// planes are the [K, 16, 160] q_tables of K cached keys (a verify context of
// K keys), and each lane reads the one of its key's index, so no per-lane
// copy of the planes is made (at K = 1,500 the table is 3.8 MB and stays in
// L2). A lane whose key is not cached (index -1) runs the one-shot lane
// code instead: verify_init_lane on its own key into a scratch row, then
// poly_lane on that row, with the decode's flag. key_lookup_kernel, launched
// before it, finds each lane's key (its first 8 bytes searched among the
// context's sorted prefixes, then the key compared whole) and orders the
// lanes so that the misses come first, with their count on the device: a
// warp takes its slots with one atomic add a route. So the misses fill
// whole warps of the keyed kernel's first blocks and no warp of hits waits
// on a Verify_Init, and nothing is read on the host. The scratch holds a
// row for each thread of one full wave of the keyed kernel at most
// (poly_keyed_scratch_rows): miss thread t runs the misses t, t + rows,
// ..., so where every lane misses the first wave's threads take the misses
// in turns, as a persistent grid would.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (poly_launch, key_lookup_launch,
// poly_keyed_scratch_rows, poly_keyed_launch), and with g++ for the CPU
// tests (poly_host, key_lookup_host, poly_keyed_host), which run the same
// per-lane code on the host.

#include "verify_lane.cuh"

constexpr int kKeyedBlock = 128;
constexpr int kKeyedBlocksPerSm = 3;     // __launch_bounds__ minimum below
constexpr int kLookupBlock = 256;

// The row of a lane's key pk among K cached keys, or -1: the lower bound of
// its first 8 bytes (as one little-endian int64) in the sorted `prefixes`,
// whose rows of `keys` [K, 32] are `rows`, then each key from there that
// shares the prefix compared whole (one, but for keys made to collide).
FE_HD int32_t lookup_lane(const uint8_t* pk, const int64_t* prefixes, const int32_t* rows,
                          const uint8_t* keys, int64_t K) {
  uint64_t word = 0;
  for (int b = 7; b >= 0; b--) word = word << 8 | pk[b];
  const int64_t prefix = (int64_t)word;
  int64_t lo = 0, hi = K;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (prefixes[mid] < prefix) lo = mid + 1; else hi = mid;
  }
  for (; lo < K && prefixes[lo] == prefix; lo++) {
    const uint8_t* key = keys + 32 * (int64_t)rows[lo];
    bool same = true;
    for (int b = 0; b < 32; b++) same &= key[b] == pk[b];
    if (same) return rows[lo];
  }
  return -1;
}

// Scratch rows of the keyed launch for n lanes on a card of `sms` SMs: a
// row for each thread of one full wave, n at most.
extern "C" int poly_keyed_scratch_rows(int64_t n, int sms) {
  const int64_t wave = (int64_t)sms * kKeyedBlocksPerSm * kKeyedBlock;
  return (int)(n < wave ? n : wave);
}

// Thread t of the keyed kernel (poly_keyed_kernel's, and poly_keyed_host's
// loop): with `misses` lanes uncached, which are order[0, misses), thread
// t < misses runs the misses t, t + rows, ... (none when t >= rows), each
// Verify_Init into its scratch row and the multiply from it; a thread from
// misses on runs hit lane order[t] against its key's q_table, and its flag
// is its key's. One call of each lane function, so the kernel holds the
// code of the multiply once (160 registers, against 168 with a call for
// each route).
FE_HD void keyed_thread(int64_t t, uint8_t* out, uint8_t* ok, uint32_t* scratch, int64_t rows,
                        const int32_t* u, const int32_t* v, const int64_t* order,
                        const int32_t* key, int64_t misses, const uint32_t* planes,
                        const uint8_t* key_ok, const uint8_t* pk, const uint32_t* tbl,
                        int64_t n) {
  const bool miss = t < misses;
  if (t >= (miss ? rows : n)) return;
  uint32_t* row = scratch + kQtWords * (miss ? t : 0);
  const int64_t end = miss ? misses : t + 1, step = miss ? rows : 1;
#pragma unroll 1
  for (int64_t j = t; j < end; j += step) {
    const int64_t lane = order[j];
    const uint32_t* qt = row;
    if (miss) {
      verify_init_lane(row, ok + lane, pk + 32 * lane);
    } else {
      const int64_t k = key[lane];
      ok[lane] = key_ok[k];
      qt = planes + kQtWords * k;
    }
    poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, qt, tbl);
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int kBlock = 128;

__device__ __forceinline__ void copy_shared(uint32_t* dst, const uint32_t* src, int words) {
  for (int c = threadIdx.x; c < words / 4; c += blockDim.x)
    reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(src)[c];
}

__global__ void __launch_bounds__(kBlock, 3)
poly_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ u,
            const int32_t* __restrict__ v, const uint32_t* __restrict__ planes,
            const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kBaseWords];
  copy_shared(tbl, table, kBaseWords);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, planes + kQtWords * lane, tbl);
}

__global__ void __launch_bounds__(kBlock, 3)
poly_shared_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ u,
                   const int32_t* __restrict__ v, const uint32_t* __restrict__ planes,
                   const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kBaseWords];
  __shared__ __align__(16) uint32_t qs[kQtWords];
  copy_shared(tbl, table, kBaseWords);
  copy_shared(qs, planes, kQtWords);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, qs, tbl);
}

// out: [n, 32] uint8; u: [n, 32] and v: [n, 64] int32 digits; planes: the
// lanes' [n, 16, 160] int8 q_tables, or one [16, 160] table when shared != 0
// (16-byte aligned); table: the fold-8 word table (16-byte aligned).
// Launches on `stream`, allocates nothing, does not synchronize and returns
// cudaGetLastError() (0 on success).
extern "C" int poly_launch(void* out, const void* u, const void* v, const void* planes,
                           int shared, const void* table, int64_t n, void* stream) {
  if (n > 0) {
    auto kernel = shared ? poly_shared_kernel : poly_kernel;
    kernel<<<(unsigned)((n + kBlock - 1) / kBlock), kBlock, 0, (cudaStream_t)stream>>>(
        (uint8_t*)out, (const int32_t*)u, (const int32_t*)v, (const uint32_t*)planes,
        (const uint32_t*)table, n);
  }
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kKeyedBlock, kKeyedBlocksPerSm)
poly_keyed_kernel(uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
                  uint32_t* __restrict__ scratch, int64_t rows, const int32_t* __restrict__ u,
                  const int32_t* __restrict__ v, const int64_t* __restrict__ order,
                  const int32_t* __restrict__ key, const int64_t* __restrict__ misses,
                  const uint32_t* __restrict__ planes, const uint8_t* __restrict__ key_ok,
                  const uint8_t* __restrict__ pk, const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kBaseWords];
  copy_shared(tbl, table, kBaseWords);
  __syncthreads();
  keyed_thread((int64_t)blockIdx.x * blockDim.x + threadIdx.x, out, ok, scratch, rows, u, v,
               order, key, *misses, planes, key_ok, pk, tbl, n);
}

// out: [n, 32] uint8 enc(R'); ok: [n] bool; scratch: [rows, 16, 160] bytes,
// overwritten, rows from 1 to poly_keyed_scratch_rows(n, sms) (16-byte
// aligned); u: [n, 32] and v: [n, 64] int32 digits; order: [n] int64, the
// lanes with key[lane] < 0 first, every lane once; key: [n] int32, the
// lane's row of planes or -1; misses: one int64 on the card, the lanes
// with key -1 (key_lookup_launch writes all three); planes: [K, 16, 160]
// int8 q_tables (16-byte aligned); key_ok: [K] bool; pk: [n, 32] uint8
// (read for the misses); table: the fold-8 word table. Launches on `stream`, allocates nothing, does not synchronize and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// rows < 1.
extern "C" int poly_keyed_launch(void* out, void* ok, void* scratch, int64_t rows, const void* u,
                                 const void* v, const void* order, const void* key,
                                 const void* misses, const void* planes, const void* key_ok,
                                 const void* pk, const void* table, int64_t n, void* stream) {
  if (n > 0) {
    if (rows < 1) return (int)cudaErrorInvalidValue;
    poly_keyed_kernel<<<(unsigned)((n + kKeyedBlock - 1) / kKeyedBlock), kKeyedBlock, 0,
                        (cudaStream_t)stream>>>(
        (uint8_t*)out, (uint8_t*)ok, (uint32_t*)scratch, rows, (const int32_t*)u,
        (const int32_t*)v, (const int64_t*)order, (const int32_t*)key, (const int64_t*)misses,
        (const uint32_t*)planes, (const uint8_t*)key_ok, (const uint8_t*)pk,
        (const uint32_t*)table, n);
  }
  return (int)cudaGetLastError();
}

// Each lane's key row (lookup_lane) into key, and its place in `order`: the
// misses from the front, the hits from the back, each warp taking its
// slots with one atomic add a route; counts = {misses, hits}.
__global__ void __launch_bounds__(kLookupBlock)
key_lookup_kernel(int32_t* __restrict__ key, int64_t* __restrict__ order,
                  unsigned long long* __restrict__ counts, const uint8_t* __restrict__ pk,
                  const int64_t* __restrict__ prefixes, const int32_t* __restrict__ rows,
                  const uint8_t* __restrict__ keys, int64_t K, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = lane < n;
  const int32_t k = live ? lookup_lane(pk + 32 * lane, prefixes, rows, keys, K) : 0;
  const unsigned miss = __ballot_sync(~0u, live && k < 0);
  const unsigned hit = __ballot_sync(~0u, live && k >= 0);
  const int me = threadIdx.x % 32;
  unsigned long long misses = 0, hits = 0;
  if (me == 0) {
    if (miss) misses = atomicAdd(counts, (unsigned long long)__popc(miss));
    if (hit) hits = atomicAdd(counts + 1, (unsigned long long)__popc(hit));
  }
  misses = __shfl_sync(~0u, misses, 0);
  hits = __shfl_sync(~0u, hits, 0);
  if (!live) return;
  key[lane] = k;
  const unsigned below = (1u << me) - 1;
  if (k < 0)
    order[misses + __popc(miss & below)] = lane;
  else
    order[n - 1 - (int64_t)(hits + __popc(hit & below))] = lane;
}

// key: [n] int32 out; order: [n] int64 out; counts: [2] int64 out, {misses,
// hits}; pk: [n, 32] uint8; prefixes: [K] int64, sorted; rows: [K] int32,
// each prefix's row of keys; keys: [K, 32] uint8. Launches on `stream` (a
// set of counts, then the kernel), allocates nothing, does not synchronize
// and returns cudaGetLastError() (0 on success).
extern "C" int key_lookup_launch(void* key, void* order, void* counts, const void* pk,
                                 const void* prefixes, const void* rows, const void* keys,
                                 int64_t K, int64_t n, void* stream) {
  cudaMemsetAsync(counts, 0, 2 * sizeof(int64_t), (cudaStream_t)stream);
  if (n > 0)
    key_lookup_kernel<<<(unsigned)((n + kLookupBlock - 1) / kLookupBlock), kLookupBlock, 0,
                        (cudaStream_t)stream>>>(
        (int32_t*)key, (int64_t*)order, (unsigned long long*)counts, (const uint8_t*)pk,
        (const int64_t*)prefixes, (const int32_t*)rows, (const uint8_t*)keys, K, n);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// Host entry: the same per-lane code on the CPU, for the tests.
extern "C" void poly_host(uint8_t* out, const int32_t* u, const int32_t* v,
                          const uint32_t* planes, int shared, const uint32_t* table, int64_t n) {
  for (int64_t i = 0; i < n; i++)
    poly_lane(out + 32 * i, u + 32 * i, v + 64 * i, planes + (shared ? 0 : kQtWords * i), table);
}

// Host entry: the keyed kernel's threads in turn (keyed_thread), for the
// tests; arguments as poly_keyed_launch's, with the misses' count as a value.
extern "C" void poly_keyed_host(uint8_t* out, uint8_t* ok, uint32_t* scratch, int64_t rows,
                                const int32_t* u, const int32_t* v, const int64_t* order,
                                const int32_t* key, int64_t misses, const uint32_t* planes,
                                const uint8_t* key_ok, const uint8_t* pk, const uint32_t* table,
                                int64_t n) {
  for (int64_t t = 0; t < n; t++)
    keyed_thread(t, out, ok, scratch, rows, u, v, order, key, misses, planes, key_ok, pk, table,
                 n);
}

// Host entry: lookup_lane over the lanes in turn, for the tests; the misses
// take `order` from the front and the hits from the back, each in lane
// order (the kernel's warps take their slots in any order); counts =
// {misses, hits}.
extern "C" void key_lookup_host(int32_t* key, int64_t* order, int64_t* counts, const uint8_t* pk,
                                const int64_t* prefixes, const int32_t* rows,
                                const uint8_t* keys, int64_t K, int64_t n) {
  counts[0] = counts[1] = 0;
  for (int64_t lane = 0; lane < n; lane++) {
    key[lane] = lookup_lane(pk + 32 * lane, prefixes, rows, keys, K);
    if (key[lane] < 0)
      order[counts[0]++] = lane;
    else
      order[n - 1 - counts[1]++] = lane;
  }
}
