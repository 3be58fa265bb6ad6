// verify.cu -- Ed25519 Verify_Init, one lane per thread (CUDA, sm_90a).
//
// Replaces the TPU kernel curve25519_tpu/ops/pallas/verify_kernel.py
// `_vinit_kernel` (verify_init_tiled) -> verify_init_kernel: decode -Q and
// build its 16-entry q_table, emitted as the context's int8 planes with the
// decode's ok flag. The planes' layout is verify_lane.cuh's; the
// double-scalar multiply that reads them is poly.cu, and the fused one-shot
// kernel oneshot.cu keeps the 13-bit Verify_Init of verify_lane.cuh
// (build_qtable). Where the TPU padded to 1024-lane tiles, each thread owns
// one lane and the grid masks lane < n.
//
// What bounds it on this card: the field products. Per lane, Verify_Init
// is 891 field multiplies and 1,024 squarings (192 doublings, 11 PE adds,
// 15 PE conversions, the sqrt ratio); the bytes (32 in, the 2,560-byte table
// and the flag out) are a sixth of the products' time. What the design
// does about it: the lane runs on the ladder's wide core, fe25519_wide.cuh
// (ten 32-bit limbs in radix 2^25.5, a multiply 100 `IMAD.WIDE.U32` against
// the 13-bit core's 400 int32 IMADs), with the point formulas of
// edwards25519_wide.cuh, which give the same field elements as the plain
// version's. The 13-bit radix is kept only where the lane crosses the
// planes: each entry is canonicalized, converted to twenty 13-bit limbs
// and split into the lo and hi planes as soon as it is made. The 192
// doublings run first and the 11 subset-sum adds after them, each reading
// both of its entries back from the planes, a coordinate at a time, just
// before the multiply that takes it; the base entry's Z and T come from its
// 2Z and 2dT by a constant multiply (22 multiplies a lane). So no point
// stays live across the adds, and the lane fits 128 registers with no
// spill: 16 warps per SM. Every loop is rolled (the 64 doublings are one
// loop): about 13,700 SASS instructions, against 36,200 on the 13-bit core.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (verify_init_launch), and with g++ for the CPU
// tests (verify_init_host; sqrt_ratio_host for the 13-bit sqrt ratio of the
// one-shot kernel), which run the same per-lane code on the host.

#include "verify_lane.cuh"
#include "edwards25519_wide.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

// Coordinate c of an entry from a wide element: canonical, as twenty 13-bit
// limbs, split into the lo and hi planes.
FE_HD void store_wide(uint32_t* entry, int c, const fe_wide::Fe& x) {
  int32_t limb[fe_wide::kLimbs13];
  fe_wide::to_limbs13(limb, fe_wide::canon(x));
  store_limbs(entry, c, limb);
}

FE_HD void store_pe(uint32_t* entry, const ed_wide::Pe& e) {
  store_wide(entry, 0, e.ypx);
  store_wide(entry, 1, e.ymx);
  store_wide(entry, 2, e.t2d);
  store_wide(entry, 3, e.z2);
}

// A stored entry read a coordinate at a time (ed_wide::add_pe's Q): the
// coordinate's canonical 13-bit limbs from the planes, as TIGHT wide limbs.
struct WideEntry {
  const uint32_t* entry;

  template <int C>
  FE_HD fe_wide::Fe coord() const {
    return fe_wide::from_limbs13(PlaneCoord{entry}.coord<C>().v);
  }
};

// A stored entry as ed_wide::add_pe's P: Y+X and Y-X as stored, T and Z
// from the stored 2dT and 2Z by a constant multiply each.
struct BaseEntry {
  const uint32_t* entry;

  template <int C>
  FE_HD fe_wide::Fe coord() const {
    const fe_wide::Fe c = WideEntry{entry}.coord<C>();
    if constexpr (C == 2) return fe_wide::mul(c, ed_wide::inv_2d());
    if constexpr (C == 3) return fe_wide::mul(c, ed_wide::inv_2());
    return c;
  }
};

// Verify_Init of one lane on the wide core: stores the 16 q_table entries
// of -Q in the planes at qt and the decode's flag in *ok
// (ops/cuda/verify_kernel.verify_init_plain). The 192 doublings come first,
// storing entries 1, 2, 4 and 8; then entry e = base + s (base the power
// of 2 below e) = entry base + entry s, both read back from the planes. Q is
// dead by then, so only pointers stay live across the adds.
FE_HD void verify_init_lane(uint32_t* qt, uint8_t* ok, const uint8_t* pk) {
  const uint32_t parity = 1 - (pk[31] >> 7);       // the parity of -Q
  const fe_wide::Fe y = fe_wide::from_bytes(pk);   // bit 255 is not read
  uint32_t decoded;
  const fe_wide::Fe x = ed_wide::calculate_x(y, parity, decoded);
  *ok = (uint8_t)decoded;
  ed_wide::Ext q = {x, y, fe_wide::one(), fe_wide::mul(x, y)};
  const fe_wide::Fe one = fe_wide::one();
  store_pe(qt, {one, one, fe_wide::Fe{}, fe_wide::add(one, one)});  // the identity
  store_pe(qt + kQtEntryWords, ed_wide::to_pe(q));
#pragma unroll 1
  for (int k = 1; k < 4; k++) {
#pragma unroll 1
    for (int i = 0; i < 64; i++) q = ed_wide::dbl(q);
    store_pe(qt + (kQtEntryWords << k), ed_wide::to_pe(q));
  }
#pragma unroll 1
  for (int e = 3; e < 16; e++) {
    const int base = e >= 8 ? 8 : e >= 4 ? 4 : 2;
    if (e == base) continue;                       // entries 4 and 8: made above
    store_pe(qt + e * kQtEntryWords,
             ed_wide::to_pe(ed_wide::add_pe(BaseEntry{qt + base * kQtEntryWords},
                                            WideEntry{qt + (e - base) * kQtEntryWords})));
  }
}

#ifdef __CUDACC__

constexpr int kBlock = 128;

// At most 128 registers a thread: four blocks, 16 warps, per SM. The lane
// fits them with no spill (ptxas; tools/ladder_probe.py times this build
// against 130 registers with no minimum, 12 warps, and others).
__global__ void __launch_bounds__(kBlock, 4)
verify_init_kernel(uint32_t* __restrict__ planes, uint8_t* __restrict__ ok,
                   const uint8_t* __restrict__ pk, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  verify_init_lane(planes + kQtWords * lane, ok + lane, pk + 32 * lane);
}

static unsigned grid(int64_t n) { return (unsigned)((n + kBlock - 1) / kBlock); }

// planes: [n, 16, 160] int8 out (16-byte aligned); ok: [n] bool out; pk:
// [n, 32] uint8. Launches on `stream`, allocates nothing, does not
// synchronize and returns cudaGetLastError() (0 on success).
extern "C" int verify_init_launch(void* planes, void* ok, const void* pk, int64_t n,
                                  void* stream) {
  if (n > 0)
    verify_init_kernel<<<grid(n), kBlock, 0, (cudaStream_t)stream>>>(
        (uint32_t*)planes, (uint8_t*)ok, (const uint8_t*)pk, n);
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
  for (int64_t i = 0; i < n; i++)
    verify_init_lane(planes + kQtWords * i, ok + i, pk + 32 * i);
}

// x, u, v: [n, 20] int32 limbs; ok: [n] int32 (fe25519::sqrt_ratio).
extern "C" void sqrt_ratio_host(int32_t* x, int32_t* ok, const int32_t* u, const int32_t* v,
                                int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    const Fe r = sqrt_ratio(load_fe(u + NLIMBS * i), load_fe(v + NLIMBS * i), ok[i]);
    for (int k = 0; k < NLIMBS; k++) x[NLIMBS * i + k] = r.v[k];
  }
}
