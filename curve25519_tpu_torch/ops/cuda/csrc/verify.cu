// verify.cu -- Ed25519 verification, one lane per thread (CUDA, sm_90a).
//
// Replaces the three TPU kernels of curve25519_tpu/ops/pallas/verify_kernel.py:
// - `_vinit_kernel` (verify_init_tiled) -> verify_init_kernel: Verify_Init.
//   Decode the 32 pk bytes (bit 255 is the parity, flipped for -Q; y >= p is
//   taken mod p), decompress x with the sqrt ratio, then build the 16-entry
//   q_table of subset sums of {-Q, 2^64(-Q), 2^128(-Q), 2^192(-Q)} in PE form
//   with 192 doublings and 11 PE adds, and emit it as the context's int8
//   planes (below) with the decode's ok flag;
// - `_poly_kernel` (poly_mult_tiled / poly_mult_tiled_shared) -> poly_kernel
//   (a q_table per lane) and poly_shared_kernel (one q_table for every lane):
//   R' = s*G + h*(-Q) from the 8-fold digits of s and the 4-fold digits of h,
//   31 x (double + PE add), 32 x (double + PA add + PE add), and enc(R');
// - `_oneshot_kernel` (verify_oneshot_tiled) -> oneshot_kernel: the two in
//   one launch; the q_table lives in a per-lane scratch row of global memory
//   that the wrapper allocates and nothing reads after the launch.
// Where the TPU padded to 1024-lane tiles, each thread owns one lane and the
// grid masks lane < n.
//
// The q_table layout is the JAX context's `planes`, [16, 160] int8 per lane:
// per entry the 80 canonical limbs of (ypx, ymx, t2d, z2), first their low 7
// bits (80 bytes), then their high 6 bits (80 bytes); a limb is lo + (hi << 7).
// Read as 32-bit words, an entry is 40 words and starts on a 16-byte
// boundary. verify_init_kernel writes each entry as soon as it is made and
// reads entries back from its own output for the subset-sum adds; the entries
// are canonical, so they equal (mod p) the weak limbs the TPU kernel added,
// and every later result is the same field element.
//
// Table reads: verify works on public data (the signature, the key, the
// message), so both tables are read at an address that depends on the digit
// (ROADMAP ground rule "Constant time"; verify_kernel.py:16-17). The 256-entry
// base table of s is one entry of the packed folding-8 table in shared memory
// (load_pa), where the masked scan of every entry that keygen and sign must
// use would cost ~254 K ALU operations per lane, about half again the loop's
// field arithmetic. The q_table entry is 10 16-byte loads: from the lane's
// row in global memory (poly_kernel, oneshot_kernel) or from shared memory
// (poly_shared_kernel copies the one table once per block). 2.5 KB per lane
// does not fit shared memory at a useful occupancy (228 KB per SM). A
// 640-word local array would (the int8 planes already hold two limbs in less
// than one word), but local memory interleaves a thread's words 128 bytes
// apart, so a read of an entry chosen per lane by the digit costs 40 lines
// per thread where a contiguous row costs 10: the one-shot kernel took
// 54.3 ms with the table in local memory against 16.1 + 20.4 ms for the two
// phases, and 41.5 ms with a global row (H100 80GB HBM3 at 700 W,
// chip_smoke.py), so it uses a global row.
//
// What bounds it on this card: int32 multiply-add issue. Per lane, Verify_Init
// is ~890 field multiplies and ~1,020 squarings, the double-scalar multiply
// with its inversion ~990 and ~510; the bytes (the 2.5 KB table per lane
// written once and read ~4 times) are far below. What the design does about
// it: nothing beyond the shared field core yet; every loop is rolled to keep the
// code and the registers small.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (verify_init_launch, poly_launch, oneshot_launch),
// and with g++ for the CPU tests (verify_init_host, poly_host, oneshot_host,
// sqrt_ratio_host), which run the same per-lane code on the host.

#include "edwards25519.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

using namespace ed25519;

constexpr int kQtEntryWords = 40;              // 160 int8 plane bytes
constexpr int kQtWords = 16 * kQtEntryWords;   // one lane's q_table

FE_HD Fe small(int32_t c) {
  Fe r;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) r.v[i] = i == 0 ? c : 0;
  return r;
}

// Ext -> PE form (models/edwards.to_pe).
FE_HD Pe to_pe(const Ext& p) {
  return {add(p.y, p.x), sub(p.y, p.x), mul(p.t, ed_2d()), add(p.z, p.z)};
}

// Coordinate c of an entry: canonical limbs split into the lo and hi planes.
FE_HD void store_coord(uint32_t* entry, int c, const Fe& x) {
  const Fe d = canon(x);
#pragma unroll
  for (int k = 0; k < NLIMBS / 4; k++) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int b = 0; b < 4; b++) {
      const uint32_t limb = (uint32_t)d.v[4 * k + b];
      lo |= (limb & 0x7F) << (8 * b);
      hi |= (limb >> 7) << (8 * b);
    }
    entry[5 * c + k] = lo;
    entry[20 + 5 * c + k] = hi;
  }
}

FE_HD void store_entry(uint32_t* entry, const Pe& e) {
  store_coord(entry, 0, e.ypx);
  store_coord(entry, 1, e.ymx);
  store_coord(entry, 2, e.t2d);
  store_coord(entry, 3, e.z2);
}

FE_HD Pe load_entry(const uint32_t* entry) {
  uint32_t w[kQtEntryWords];
  load_words(w, entry);
  int32_t limb[4 * NLIMBS];
#pragma unroll
  for (int k = 0; k < 20; k++) {
#pragma unroll
    for (int b = 0; b < 4; b++)
      limb[4 * k + b] = (int32_t)(((w[k] >> (8 * b)) & 0xFF) + (((w[20 + k] >> (8 * b)) & 0xFF) << 7));
  }
  Pe e;
#pragma unroll
  for (int i = 0; i < NLIMBS; i++) {
    e.ypx.v[i] = limb[i];
    e.ymx.v[i] = limb[NLIMBS + i];
    e.t2d.v[i] = limb[2 * NLIMBS + i];
    e.z2.v[i] = limb[3 * NLIMBS + i];
  }
  return e;
}

// x from y with the given parity, and ok = 1 where (y^2 - 1)/(d y^2 + 1) is a
// square (models/edwards.calculate_x).
FE_HD Fe calculate_x(const Fe& y, int32_t parity, int32_t& ok) {
  const Fe y2 = sqr(y);
  const Fe u = sub(y2, one());
  const Fe v = add(mul(y2, ed_d()), one());
  const Fe x = sqrt_ratio(u, v, ok);
  const Fe xc = canon(x);
  return select((xc.v[0] ^ parity) & 1, neg(xc), xc);
}

// Verify_Init of one lane: writes the 16 q_table entries of -Q to qt and
// returns ok (ops/cuda/verify_kernel.verify_init_plain).
FE_HD int32_t build_qtable(uint32_t* qt, const uint8_t* pk) {
  int32_t b[32];
#pragma unroll
  for (int j = 0; j < 32; j++) b[j] = pk[j];
  const int32_t parity = 1 - ((b[31] >> 7) & 1);  // the parity of -Q
  b[31] &= 0x7F;
  const Fe y = from_bytes(b);
  int32_t ok;
  const Fe x = calculate_x(y, parity, ok);
  Ext q = {x, y, one(), mul(x, y)};
  store_entry(qt, {small(1), small(1), small(0), small(2)});  // the identity
  store_entry(qt + kQtEntryWords, to_pe(q));
#pragma unroll 1
  for (int base = 2; base < 16; base *= 2) {
#pragma unroll 1
    for (int i = 0; i < 64; i++) q = dbl(q);
    store_entry(qt + base * kQtEntryWords, to_pe(q));
#pragma unroll 1
    for (int s = 1; s < base; s++)
      store_entry(qt + (base + s) * kQtEntryWords,
                  to_pe(add_pe(q, load_entry(qt + s * kQtEntryWords))));
  }
  return ok;
}

// enc(s*G + h*(-Q)) of one lane (ops/cuda/verify_kernel.poly_mult_plain).
// u: the 32 8-fold digits of s; v: the 64 4-fold digits of h; qt: the lane's
// q_table; tbl: the packed folding-8 table. Digits are read mod 256 and 16.
FE_HD void poly_lane(uint8_t* out, const int32_t* u, const int32_t* v, const uint32_t* qt,
                     const uint32_t* tbl) {
  const Pe q0 = load_entry(qt + (v[0] & 15) * kQtEntryWords);
  Ext s = {sub(q0.ypx, q0.ymx), add(q0.ypx, q0.ymx), q0.z2, mul(q0.t2d, ed_di())};
#pragma unroll 1
  for (int i = 1; i < 32; i++) s = add_pe(dbl(s), load_entry(qt + (v[i] & 15) * kQtEntryWords));
#pragma unroll 1
  for (int i = 0; i < 32; i++) {
    Fe ypx, ymx, t2d;
    load_pa(ypx, ymx, t2d, tbl, u[i] & 255);
    s = add_pa(dbl(s), ypx, ymx, t2d);
    s = add_pe(s, load_entry(qt + (v[32 + i] & 15) * kQtEntryWords));
  }
  int32_t enc[32];
  pack_ext(enc, s);
#pragma unroll
  for (int j = 0; j < 32; j++) out[j] = (uint8_t)enc[j];
}

#ifdef __CUDACC__

constexpr int kBlock = 128;
constexpr int kTableWords = 256 * kEntryWords;

__device__ __forceinline__ void load_shared(uint32_t* dst, const uint32_t* src, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kBlock)
verify_init_kernel(uint32_t* __restrict__ planes, uint8_t* __restrict__ ok,
                   const uint8_t* __restrict__ pk, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  ok[lane] = (uint8_t)build_qtable(planes + kQtWords * lane, pk + 32 * lane);
}

__global__ void __launch_bounds__(kBlock)
poly_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ u,
            const int32_t* __restrict__ v, const uint32_t* __restrict__ planes,
            const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kTableWords];
  load_shared(tbl, table, kTableWords);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, planes + kQtWords * lane, tbl);
}

__global__ void __launch_bounds__(kBlock)
poly_shared_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ u,
                   const int32_t* __restrict__ v, const uint32_t* __restrict__ planes,
                   const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kTableWords];
  __shared__ __align__(16) uint32_t qs[kQtWords];
  load_shared(tbl, table, kTableWords);
  load_shared(qs, planes, kQtWords);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, qs, tbl);
}

__global__ void __launch_bounds__(kBlock)
oneshot_kernel(uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
               uint32_t* __restrict__ scratch, const uint8_t* __restrict__ pk,
               const int32_t* __restrict__ u, const int32_t* __restrict__ v,
               const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kTableWords];
  load_shared(tbl, table, kTableWords);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t* qt = scratch + kQtWords * lane;
  ok[lane] = (uint8_t)build_qtable(qt, pk + 32 * lane);
  poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, qt, tbl);
}

static unsigned grid(int64_t n) { return (unsigned)((n + kBlock - 1) / kBlock); }

// planes: [n, 16, 160] int8 out (16-byte aligned); ok: [n] bool out; pk:
// [n, 32] uint8. Every launch entry launches on `stream`, allocates nothing,
// does not synchronize and returns cudaGetLastError() (0 on success).
extern "C" int verify_init_launch(void* planes, void* ok, const void* pk, int64_t n,
                                  void* stream) {
  if (n > 0)
    verify_init_kernel<<<grid(n), kBlock, 0, (cudaStream_t)stream>>>(
        (uint32_t*)planes, (uint8_t*)ok, (const uint8_t*)pk, n);
  return (int)cudaGetLastError();
}

// out: [n, 32] uint8; u: [n, 32] and v: [n, 64] int32 digits; planes: the
// lanes' [n, 16, 160] int8 q_tables, or one [16, 160] table when shared != 0
// (16-byte aligned); table: the packed folding-8 table.
extern "C" int poly_launch(void* out, const void* u, const void* v, const void* planes,
                           int shared, const void* table, int64_t n, void* stream) {
  if (n > 0) {
    auto kernel = shared ? poly_shared_kernel : poly_kernel;
    kernel<<<grid(n), kBlock, 0, (cudaStream_t)stream>>>(
        (uint8_t*)out, (const int32_t*)u, (const int32_t*)v, (const uint32_t*)planes,
        (const uint32_t*)table, n);
  }
  return (int)cudaGetLastError();
}

// out: [n, 32] uint8 enc(R'); ok: [n] bool; scratch: [n, 16, 160] bytes, 16-byte
// aligned, overwritten; pk: [n, 32] uint8; u, v, table as poly_launch.
extern "C" int oneshot_launch(void* out, void* ok, void* scratch, const void* pk, const void* u,
                              const void* v, const void* table, int64_t n, void* stream) {
  if (n > 0)
    oneshot_kernel<<<grid(n), kBlock, 0, (cudaStream_t)stream>>>(
        (uint8_t*)out, (uint8_t*)ok, (uint32_t*)scratch, (const uint8_t*)pk, (const int32_t*)u,
        (const int32_t*)v, (const uint32_t*)table, n);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// ---------------------------------------------------------------------------
// Host entries: the same per-lane code on the CPU, for the tests.
// ---------------------------------------------------------------------------
extern "C" void verify_init_host(uint32_t* planes, uint8_t* ok, const uint8_t* pk, int64_t n) {
  for (int64_t i = 0; i < n; i++) ok[i] = (uint8_t)build_qtable(planes + kQtWords * i, pk + 32 * i);
}

extern "C" void poly_host(uint8_t* out, const int32_t* u, const int32_t* v,
                          const uint32_t* planes, int shared, const uint32_t* table, int64_t n) {
  for (int64_t i = 0; i < n; i++)
    poly_lane(out + 32 * i, u + 32 * i, v + 64 * i, planes + (shared ? 0 : kQtWords * i), table);
}

extern "C" void oneshot_host(uint8_t* out, uint8_t* ok, const uint8_t* pk, const int32_t* u,
                             const int32_t* v, const uint32_t* table, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    uint32_t qt[kQtWords];
    ok[i] = (uint8_t)build_qtable(qt, pk + 32 * i);
    poly_lane(out + 32 * i, u + 32 * i, v + 64 * i, qt, table);
  }
}

// x, u, v: [n, 20] int32 limbs; ok: [n] int32 (fe25519::sqrt_ratio).
extern "C" void sqrt_ratio_host(int32_t* x, int32_t* ok, const int32_t* u, const int32_t* v,
                                int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    const Fe r = sqrt_ratio(load_fe(u + NLIMBS * i), load_fe(v + NLIMBS * i), ok[i]);
    for (int k = 0; k < NLIMBS; k++) x[NLIMBS * i + k] = r.v[k];
  }
}
