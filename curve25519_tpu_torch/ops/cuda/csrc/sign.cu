// sign.cu -- fused Ed25519 keygen and sign, one lane per thread (CUDA,
// sm_90a).
//
// Replaces the TPU kernels of curve25519_tpu/ops/pallas/sign_kernel.py:
// - `_keygen_kernel` (keygen_tiled / keygen_fused_pallas): SHA512(seed) ->
//   clamp -> 8-fold cut -> folding base multiply -> compressed pk, with the
//   blinded form (a + bl)*G + BP when bl and bp are given;
// - `_sign_kernel` (sign_tiled / sign_fused_pallas): the whole signature in
//   one launch: md = SHA512(seed); r = SHA512(prefix || m) mod l;
//   R = r*G (blinded: (r + bl)*G + BP); h = SHA512(R || pk || m) mod l;
//   S = h*a + r mod l.
// As on the TPU, the message words of the two message hashes are packed by
// the wrapper with a zero hole at the front of block 0 (32 bytes for the
// prefix, 64 for R || pk; the FIPS padding depends only on the total
// length), and the lane splices its in-kernel values into that hole: the
// prefix half of md, enc(R) and the pk. The mod-l code is sc25519.cuh
// (sc_tile), on 13-bit limbs; the base multiply is fold_wide.cuh's lane on
// the wide field core.
//
// What bounds it on this card: the base multiply's field products on the
// FMA pipe, 31 x (4 M + 4 S + 7 M) and the inversion, ~730 multiplies and
// squarings a lane; the three SHA-512 runs and the mod-l steps add ALU and
// IMAD work. What the design does about it: the base multiply runs on the
// wide core (fe25519_wide.cuh, a multiply is 100 `IMAD.WIDE.U32` against
// the 13-bit core's ~420 IMAD) through edwards25519_wide.cuh's formulas in
// the plain version's order, so enc(R) and pk are the same bytes; one SHA
// compression function and one rolled loop over blocks and over fold steps
// keep the code and the registers small; the 8-fold digits are read from
// the scalar's 8 words at each step (fold_wide::CombDigits), so no per-lane
// array is indexed by the step counter.
//
// Both kernels' 32 constant-time table reads run on the tensor cores
// (gather_mma.cuh): per warp and read, 192 int8 one-hot mma.sync products
// over the word table in shared memory, in B-fragment order, each lane
// getting its entry's canonical words. No address and no branch depends on
// a digit: every warp reads every entry, the digits only select values.
// Shared memory per block: the 24 KB table and a staging row per warp
// (3.5 KB), dynamic.
// mma.sync needs the whole warp, so no lane returns before the end: a warp
// wholly past n leaves at once, the lanes of a partial warp past n
// recompute lane n - 1 (their reads stay in bounds and their digits in
// range) and store nothing, and the gather's own __syncwarp() follows
// sign's per-lane SHA-512 loops, whose block counts differ. Keygen's steps
// before the gathers (one SHA-512 block, the clamp, the blinded mod-l add)
// are the same for every lane.
//
// Built by curve25519_tpu_torch/ops/cuda/build.py: with nvcc into a shared
// library that ctypes loads (keygen_launch, sign_launch), and with g++ for
// the CPU tests (keygen_host with the masked scan or the host emulation of
// the tensor-core gather, sign_host with the masked scan, gather_host,
// sc25519_op_host).

#include "fold_wide.cuh"
#include "gather_mma.cuh"
#include "sc25519.cuh"
#include "sha512.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

using namespace fe25519;

// SHA-512 state of a 32-byte seed: one block built in registers.
FE_HD void seed_hash(uint64_t (&st)[8], const uint8_t* seed) {
  uint64_t w[16];
#pragma unroll
  for (int t = 0; t < 4; t++) w[t] = sha512::be_word(seed + 8 * t);
  w[4] = 0x8000000000000000ULL;
#pragma unroll
  for (int t = 5; t < 15; t++) w[t] = 0;
  w[15] = 256;  // bit length
  sha512::init(st);
  sha512::compress(st, w);
}

// a = clamp(md[0:32]) as normalized limbs.
FE_HD Fe secret_scalar(const uint64_t (&md)[8]) {
  int32_t by[64], a[32];
  sha512::digest_bytes(by, md);
#pragma unroll
  for (int j = 0; j < 32; j++) a[j] = by[j];
  sc25519::clamp(a);
  return from_bytes(a);
}

// (scalar + bl)*G + BP, or scalar*G without blinding, compressed, as 8
// little-endian words; scalar: normalized 13-bit limbs. words: a
// constant-time words source of the fold-8 word table (gather_mma's, or the
// masked scan on the host).
template <class Words>
FE_HD void blinded_base_pk(uint32_t (&enc)[8], const Fe& scalar, const int32_t* zr,
                           const int32_t* bl, const int32_t* bp, const Words& words) {
  const Fe a = bl ? sc25519::add(scalar, load_fe(bl)) : scalar;
  fold_wide::CombDigits dig;
  fe_wide::words_from_limbs13(dig.w, a.v);
  fold_wide::pack_words(enc, fold_wide::base_mult<32>(dig, zr, bp, words));
}

// Byte j of little-endian words.
FE_HD uint8_t word_byte(const uint32_t (&w)[8], int j) {
  return (uint8_t)(w[j / 4] >> (8 * (j % 4)));
}

// pk: 32 bytes out, or null to store nothing; words: as blinded_base_pk's.
template <class Words>
FE_HD void keygen_lane(uint8_t* pk, const uint8_t* seed, const int32_t* zr,
                       const int32_t* bl, const int32_t* bp, const Words& words) {
  uint64_t md[8];
  seed_hash(md, seed);
  Fe a = secret_scalar(md);
  if (bl) a = sc25519::mod(a);  // the blinded route adds bl to a mod l
  uint32_t enc[8];
  blinded_base_pk(enc, a, zr, bl, bp, words);
  if (!pk) return;
#pragma unroll
  for (int j = 0; j < 32; j++) pk[j] = word_byte(enc, j);
}

// priv: 64 bytes (seed || pk); w2, w3: the lane's padded word rows of
// (32-byte hole || m) and (64-byte hole || m) with nb2, nb3 active blocks;
// sig: 64 bytes out, or null to store nothing.
template <class Words>
FE_HD void sign_lane(uint8_t* sig, const uint8_t* priv, const int32_t* w2, int32_t nb2,
                     const int32_t* w3, int32_t nb3, const int32_t* zr, const int32_t* bl,
                     const int32_t* bp, const Words& words) {
  uint64_t md[8], st[8], w[16];
  int32_t by[64];
  seed_hash(md, priv);

  // r = SHA512(prefix || m) mod l, prefix = md bytes 32..63 = md[4..7]
  sha512::init(st);
#pragma unroll 1
  for (int32_t b = 0; b < nb2; b++) {
    sha512::load_block(w, w2, b);
    if (b == 0) {
#pragma unroll
      for (int t = 0; t < 4; t++) w[t] = md[4 + t];
    }
    sha512::compress(st, w);
  }
  sha512::digest_bytes(by, st);
  const Fe r = sc25519::from_digest(by);

  uint32_t R[8];
  blinded_base_pk(R, r, zr, bl, bp, words);

  // h = SHA512(enc(R) || pk || m) mod l
  sha512::init(st);
#pragma unroll 1
  for (int32_t b = 0; b < nb3; b++) {
    sha512::load_block(w, w3, b);
    if (b == 0) {
#pragma unroll
      for (int t = 0; t < 4; t++) {
        uint8_t rb[8];
#pragma unroll
        for (int k = 0; k < 8; k++) rb[k] = word_byte(R, 8 * t + k);
        w[t] = sha512::be_word(rb);
        w[4 + t] = sha512::be_word(priv + 32 + 8 * t);
      }
    }
    sha512::compress(st, w);
  }
  sha512::digest_bytes(by, st);
  const Fe h = sc25519::from_digest(by);

  // S = h*a + r mod l
  int32_t s_bytes[32];
  norm_to_bytes(s_bytes, sc25519::muladd(h, sc25519::mod(secret_scalar(md)), r));
  if (!sig) return;
#pragma unroll
  for (int j = 0; j < 32; j++) {
    sig[j] = word_byte(R, j);
    sig[32 + j] = (uint8_t)s_bytes[j];
  }
}

#ifdef __CUDACC__

// Both kernels' block size and minimum of blocks per SM: at most 168
// registers a thread, 12 warps per SM (PERF.md section 6 lists each shape
// tried).
constexpr int kBlock = 128;
constexpr int kMinBlocks = 3;
// Dynamic shared memory of keygen_kernel and sign_kernel: the table in B
// order, then one staging row per warp.
constexpr int kSmemBytes =
    4 * (gather_mma::kTableWords + (kBlock / 32) * gather_mma::kStageWords);

__global__ void __launch_bounds__(kBlock, kMinBlocks)
keygen_kernel(uint8_t* __restrict__ pk, const uint8_t* __restrict__ sk,
              const int32_t* __restrict__ zr, int64_t zr_stride, const int32_t* __restrict__ bl,
              int64_t bl_stride, const int32_t* __restrict__ bp, int64_t bp_stride,
              const uint32_t* __restrict__ table, int64_t n) {
  extern __shared__ __align__(16) uint32_t smem[];
  const gather_mma::Gather gather = gather_mma::load_table(smem, table);
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~(int64_t)31) >= n) return;  // the whole warp is past n
  const int64_t row = lane < n ? lane : n - 1;
  keygen_lane(lane < n ? pk + 32 * lane : nullptr, sk + 32 * row,
              zr ? zr + zr_stride * row : nullptr, bl ? bl + bl_stride * row : nullptr,
              bp ? bp + bp_stride * row : nullptr, gather);
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
sign_kernel(uint8_t* __restrict__ sig, const uint8_t* __restrict__ priv,
            const int32_t* __restrict__ w2, int64_t nw2, const int32_t* __restrict__ nb2,
            const int32_t* __restrict__ w3, int64_t nw3, const int32_t* __restrict__ nb3,
            const int32_t* __restrict__ zr, int64_t zr_stride, const int32_t* __restrict__ bl,
            int64_t bl_stride, const int32_t* __restrict__ bp, int64_t bp_stride,
            const uint32_t* __restrict__ table, int64_t n) {
  extern __shared__ __align__(16) uint32_t smem[];
  const gather_mma::Gather gather = gather_mma::load_table(smem, table);
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((lane & ~(int64_t)31) >= n) return;  // the whole warp is past n
  const int64_t row = lane < n ? lane : n - 1;
  sign_lane(lane < n ? sig + 64 * lane : nullptr, priv + 64 * row, w2 + nw2 * row, nb2[row],
            w3 + nw3 * row, nb3[row], zr ? zr + zr_stride * row : nullptr,
            bl ? bl + bl_stride * row : nullptr, bp ? bp + bp_stride * row : nullptr, gather);
}

// pk: [n, 32] uint8 out; sk: [n, 32] uint8 seeds; zr, bl: 20-limb int32
// rows and bp: 80-limb rows at their strides (0: one shared row), each
// possibly null (bl and bp together); table: the fold-8 word table in B
// order (edwards_kernel.mma_word_table, 16-byte aligned). Launches on `stream`,
// allocates nothing, does not synchronize. Returns cudaGetLastError(), or
// the error of a refused shared-memory attribute.
extern "C" int keygen_launch(void* pk, const void* sk, const void* zr, int64_t zr_stride,
                             const void* bl, int64_t bl_stride, const void* bp,
                             int64_t bp_stride, const void* table, int64_t n, void* stream) {
  if (n > 0) {
    const cudaError_t rc = cudaFuncSetAttribute(
        keygen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (rc != cudaSuccess) return (int)rc;
    const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);
    keygen_kernel<<<blocks, kBlock, kSmemBytes, (cudaStream_t)stream>>>(
        (uint8_t*)pk, (const uint8_t*)sk, (const int32_t*)zr, zr_stride, (const int32_t*)bl,
        bl_stride, (const int32_t*)bp, bp_stride, (const uint32_t*)table, n);
  }
  return (int)cudaGetLastError();
}

// sig: [n, 64] uint8 out; priv: [n, 64] uint8 (seed || pk); w2: [n, nw2] and
// w3: [n, nw3] int32 padded word rows with nb2, nb3: [n] int32 active
// blocks; the rest as keygen_launch.
extern "C" int sign_launch(void* sig, const void* priv, const void* w2, int64_t nw2,
                           const void* nb2, const void* w3, int64_t nw3, const void* nb3,
                           const void* zr, int64_t zr_stride, const void* bl, int64_t bl_stride,
                           const void* bp, int64_t bp_stride, const void* table, int64_t n,
                           void* stream) {
  if (n > 0) {
    const cudaError_t rc = cudaFuncSetAttribute(
        sign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (rc != cudaSuccess) return (int)rc;
    const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);
    sign_kernel<<<blocks, kBlock, kSmemBytes, (cudaStream_t)stream>>>(
        (uint8_t*)sig, (const uint8_t*)priv, (const int32_t*)w2, nw2, (const int32_t*)nb2,
        (const int32_t*)w3, nw3, (const int32_t*)nb3, (const int32_t*)zr, zr_stride,
        (const int32_t*)bl, bl_stride, (const int32_t*)bp, bp_stride, (const uint32_t*)table, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__

// ---------------------------------------------------------------------------
// Host entries: the same per-lane code on the CPU, for the tests.
// ---------------------------------------------------------------------------
// mma = 0: the masked scan of the word table (edwards_kernel.word_table(8));
// mma = 1: the host emulation of the tensor-core gather over the word table
// in B order (edwards_kernel.mma_word_table), lane i at position i % 32 of
// its warp.
extern "C" void keygen_host(int mma, uint8_t* pk, const uint8_t* sk, const int32_t* zr,
                            int64_t zr_stride, const int32_t* bl, int64_t bl_stride,
                            const int32_t* bp, int64_t bp_stride, const uint32_t* table,
                            int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    const int32_t* z = zr ? zr + zr_stride * i : nullptr;
    const int32_t* l = bl ? bl + bl_stride * i : nullptr;
    const int32_t* b = bp ? bp + bp_stride * i : nullptr;
    if (mma)
      keygen_lane(pk + 32 * i, sk + 32 * i, z, l, b,
                  gather_mma::HostGather{table, (int)(i & 31)});
    else
      keygen_lane(pk + 32 * i, sk + 32 * i, z, l, b, fold_wide::ScanWords<256>{table});
  }
}

// table: the word table (edwards_kernel.word_table(8)), read by the masked
// scan.
extern "C" void sign_host(uint8_t* sig, const uint8_t* priv, const int32_t* w2, int64_t nw2,
                          const int32_t* nb2, const int32_t* w3, int64_t nw3, const int32_t* nb3,
                          const int32_t* zr, int64_t zr_stride, const int32_t* bl,
                          int64_t bl_stride, const int32_t* bp, int64_t bp_stride,
                          const uint32_t* table, int64_t n) {
  for (int64_t i = 0; i < n; i++)
    sign_lane(sig + 64 * i, priv + 64 * i, w2 + nw2 * i, nb2[i], w3 + nw3 * i, nb3[i],
              zr ? zr + zr_stride * i : nullptr, bl ? bl + bl_stride * i : nullptr,
              bp ? bp + bp_stride * i : nullptr, fold_wide::ScanWords<256>{table});
}

// out: [n, 24] uint32, the words ypx ++ ymx ++ t2d of fold-8 entry dig[i],
// by the masked scan (mma = 0; table: edwards_kernel.word_table(8)) or by
// the host emulation of the tensor-core gather, 32 lanes per warp and the
// last warp partial (mma = 1; table: edwards_kernel.mma_word_table).
extern "C" void gather_host(int mma, uint32_t* out, const int32_t* dig, const uint32_t* table,
                            int64_t n) {
  auto rows = reinterpret_cast<uint32_t(*)[gather_mma::kWords]>(out);
  if (mma) {
    for (int64_t w = 0; w < n; w += 32)
      gather_mma::mma_gather_host(rows + w, dig + w, (int)(n - w < 32 ? n - w : 32), table);
    return;
  }
  for (int64_t i = 0; i < n; i++) {
    uint32_t w[3][8];
    fold_wide::ScanWords<256>{table}(w, dig[i]);
    for (int k = 0; k < gather_mma::kWords; k++) rows[i][k] = w[k / 8][k % 8];
  }
}

enum ScOp { SC_MOD, SC_ADD, SC_MUL, SC_MULADD, SC_SUB_FROM_ELL, SC_FROM_DIGEST, SC_CUT8 };

// One mod-l op over n lanes. x, y, z, out: [n, 20] int32 limbs, except that
// SC_FROM_DIGEST reads x as [n, 64] byte values and SC_CUT8 writes [n, 32]
// digits. Returns 0, or -1 for an unknown op.
extern "C" int sc25519_op_host(int op, int32_t* out, const int32_t* x, const int32_t* y,
                               const int32_t* z, int64_t n) {
  for (int64_t lane = 0; lane < n; lane++) {
    Fe a, b, c, r;
    if (op == SC_FROM_DIGEST) {
      int32_t by[64];
      for (int j = 0; j < 64; j++) by[j] = x[64 * lane + j];
      r = sc25519::from_digest(by);
    } else {
      a = load_fe(x + NLIMBS * lane);
      b = y ? load_fe(y + NLIMBS * lane) : a;
      c = z ? load_fe(z + NLIMBS * lane) : a;
      switch (op) {
        case SC_MOD: r = sc25519::mod(a); break;
        case SC_ADD: r = sc25519::add(a, b); break;
        case SC_MUL: r = sc25519::mul(a, b); break;
        case SC_MULADD: r = sc25519::muladd(a, b, c); break;
        case SC_SUB_FROM_ELL: r = sc25519::sub_from_ell(a); break;
        case SC_CUT8: {  // the kernels' digits: from the scalar's words
          fold_wide::CombDigits dig;
          fe_wide::words_from_limbs13(dig.w, a.v);
          for (int j = 0; j < 32; j++) out[32 * lane + j] = dig[j];
          continue;
        }
        default: return -1;
      }
    }
    for (int i = 0; i < NLIMBS; i++) out[NLIMBS * lane + i] = r.v[i];
  }
  return 0;
}
