"""Measure the X25519 ladder, Verify_Init, fold-4 and fold-8 base-multiply,
double-scalar multiply, one-shot verify, keygen and sign kernels and the
field cores on one CUDA card.

    python3 tools/ladder_probe.py [--parent DIR] [--variants 64:1,128:4]
                                  [--vinit-variants 128:3,64:6,256:2]
                                  [--fold4-variants 128:4:2,128:4:1,256:2:1]
                                  [--poly-variants 128:4,256:2]
                                  [--oneshot-variants 512:1:1:1,256:2:2:2]
                                  [--fold8-variants 128:4,256:2]
                                  [--sign-variants 128:4,128:2]
                                  [--only cores,ladder,vinit,poly,oneshot,
                                          fold4,fold8,sign]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Prints one line per measurement and, last, one JSON object of them all;
builds into curve25519_tpu_torch/ops/cuda/_build/probe/ (git-ignored):

1. Field cores, one op at a time, over 262,144 lanes at 256 threads a
   block: the 13-bit core of the Edwards kernels (csrc/fe25519.cuh), the
   ladder's wide core (csrc/fe25519_wide.cuh) and the alternative weighed
   against it, eight 32-bit words with lazy reduction by 2^256 = 38 (the
   reference library's portable core, written out here and nowhere else).
   For each op: the SASS opcodes of one trip of a chain kernel that does
   one op per trip (x, y = x * y, x; or x = x^2), ptxas's registers, and
   the device time of one op per lane. Also one Edwards doubling per trip
   (P = 2P) on the 13-bit core (csrc/edwards25519.cuh) and on the wide core
   (csrc/edwards25519_wide.cuh), and one fold-4 step per trip (a doubling,
   the constant-time scan of the 16-entry table in shared memory, a table
   add): the 13-bit core's over the packed table (edwards_kernel.
   packed_table) and the wide core's over the word table (word_table,
   csrc/fold_wide.cuh). And one step of the double-scalar multiply per trip
   (a doubling, a PA add of a fold-8 entry read by index, a PE add of a
   q_table entry read from int8 planes, both tables in shared memory): the
   wide core's as verify_lane.cuh's poly_lane does it (the word table, each
   PE coordinate decoded just before its multiply), and the 13-bit core's
   (the packed table, the entry decoded whole). And one fold-8 step per trip
   (a doubling, the tensor-core gather of csrc/gather_mma.cuh over the word
   table in B order, edwards_kernel.mma_word_table, in dynamic shared
   memory, each lane of a warp asking for its own entry, a table add): the
   wide core's as fold_wide.cuh does it (the words through from_words), and
   the 13-bit core's as the fold-8 limb modes do it (the words as 13-bit
   limbs).
2. Ladder builds: the checkout's csrc/ladder.cu as it ships; its lane
   function in a kernel of the probe's own at each `--variants`
   threads:min_blocks (block size and __launch_bounds__ minimum); and, with
   `--parent`, the csrc/ladder.cu of another checkout (a `git archive` of
   the parent commit, say). Each gets its registers, spills and the SASS
   opcodes of the whole kernel and of its longest loop (one ladder step);
   all run on the same lanes, must return the same bytes, and are timed
   in turns (builds in order, then reversed, three times; each the best of
   3 launches by CUDA events).
3. Verify_Init builds, the same way: the checkout's csrc/verify.cu, its
   lane (verify.cu's verify_init_lane) at each `--vinit-variants`
   threads:min_blocks, and the parent's csrc/verify.cu, on 262,144 random
   keys (about half of them off the curve); planes and flags must agree.
4. Fold-4 base-multiply builds, the same way: the checkout's
   basemult_fold4_kernel (csrc/basemult.cu) in the "u_bytes" mode of
   calculate_public_key_fast(nfolds=4), its lane (fold_wide::lane) at each
   `--fold4-variants` threads:min_blocks (0: no minimum), optionally with
   another count of scan entries per loop trip (:unroll), and the parent's
   basemult_fold4_kernel, each on the table its launch reads, on 262,144
   random scalars' digits; the bytes must agree.
5. Double-scalar multiply builds, the same way: the checkout's poly_kernel
   (csrc/poly.cu, a q_table per lane), its lane (verify_lane.cuh's
   poly_lane) at each `--poly-variants` threads:min_blocks, and the
   parent's poly_kernel, each on the fold-8 table its launch reads, on the
   planes of 262,144 random keys and random digits; the bytes must agree.
6. One-shot verify builds, the same way: the checkout's oneshot_kernel
   (csrc/oneshot.cu), its two phases at each `--oneshot-variants`
   threads:min_blocks[:blocks per SM of the grid[:barriers[:balanced]]]
   (persistent blocks as the shipped kernel, or 0: a block per tile, a
   scratch row per lane; barriers after both phases, after Verify_Init
   only as shipped, or none), and the parent's oneshot_kernel, on 262,144
   random keys and digits; bytes and flags must agree.
7. Fold-8 byte-mode builds: the checkout's csrc/basemult.cu as it ships
   and with FOLD8_BLOCK and FOLD8_MIN_BLOCKS set to each `--fold8-variants`
   threads:min_blocks, basemult_fold8_kernel in the "u_bytes" mode of
   calculate_public_key_fast on 262,144 random scalars' digits; the bytes
   must agree. No parent build: a parent's fold-8 kernel may read another
   table layout.
8. Keygen and sign builds, the same way: the checkout's csrc/sign.cu as it
   ships and with SIGN_BLOCK and SIGN_MIN_BLOCKS set to each
   `--sign-variants` threads:min_blocks, keygen_kernel on 262,144 random
   seeds and sign_kernel on 64-byte messages under those keys, both with
   the default zr; the bytes must agree.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from curve25519_tpu_torch.ops import codec, fold  # noqa: E402
from curve25519_tpu_torch.ops.cuda import build, edwards_kernel  # noqa: E402

PROBE_DIR = build.BUILD_DIR / "probe"
THREADS = 256
BATCH = 262_144
ROUNDS = 3
# SASS opcodes by pipe: IMAD* on the FMA pipe; these on the ALU pipe
ALU_OPS = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "IABS", "IMNMX",
           "PRMT", "SHL", "SHR", "FLO", "POPC", "BMSK", "SGXT", "PLOP3")

CORES_SRC = r"""
#include "fe25519.cuh"
#include "fe25519_wide.cuh"
#include "edwards25519.cuh"
#include "edwards25519_wide.cuh"
#include "fold_wide.cuh"
#include "gather_mma.cuh"
#include "verify_lane.cuh"
#include <cuda_runtime.h>

// Eight 32-bit words, lazy reduction by 2^256 = 38 (mod p): the reference
// library's portable core (ecp_MulReduce, ecp_SqrReduce), for comparison.
namespace w8 {
struct Fe { uint32_t v[8]; };
// t (16 words) folded by 2^256 = 38 into 8 words, below 2^256
FE_HD Fe fold(const uint32_t* t) {
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)t[i + 8] * 38 + t[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  c *= 38;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += r.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  r.v[0] += 38 * (uint32_t)c;
  return r;
}
FE_HD Fe mul(const Fe& a, const Fe& b) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a.v[i] * b.v[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  return fold(t);
}
// 28 cross products, doubled by a shift, plus the 8 squares
FE_HD Fe sqr(const Fe& a) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 7; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < 8; j++) {
      c += (uint64_t)a.v[i] * a.v[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  uint32_t top = 0;
#pragma unroll
  for (int i = 0; i < 16; i++) {
    const uint32_t w = t[i];
    t[i] = (w << 1) | top;
    top = w >> 31;
  }
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint64_t s = (uint64_t)a.v[i] * a.v[i];
    c += (uint64_t)t[2 * i] + (uint32_t)s;
    t[2 * i] = (uint32_t)c;
    c = (c >> 32) + t[2 * i + 1] + (s >> 32);
    t[2 * i + 1] = (uint32_t)c;
    c >>= 32;
  }
  return fold(t);
}
}  // namespace w8

#define CHAIN(NAME, NS, N, T, STEP)                                         \
  __global__ void __launch_bounds__(256) NAME(uint32_t* io, int iters) {    \
    const int t = blockIdx.x * blockDim.x + threadIdx.x;                    \
    NS::Fe x, y;                                                            \
    _Pragma("unroll") for (int i = 0; i < N; i++) {                         \
      x.v[i] = (T)io[(2 * t) * N + i];                                      \
      y.v[i] = (T)io[(2 * t + 1) * N + i];                                  \
    }                                                                       \
    _Pragma("unroll 1") for (int it = 0; it < iters; it++) { STEP; }        \
    _Pragma("unroll") for (int i = 0; i < N; i++)                           \
      io[(2 * t) * N + i] = (uint32_t)x.v[i];                               \
  }

#define OPS(CORE, NS, N, T, MUL, SQR)                                       \
  CHAIN(CORE##_mul, NS, N, T, const NS::Fe p = MUL(x, y); y = x; x = p)     \
  CHAIN(CORE##_sqr, NS, N, T, x = SQR(x))

OPS(fe13, fe25519, 20, int32_t, fe25519::mul, fe25519::sqr)
OPS(wide, fe_wide, 10, uint32_t, fe_wide::mul, fe_wide::sqr)
OPS(w8, w8, 8, uint32_t, w8::mul, w8::sqr)

// One Edwards doubling per trip, the point's four coordinates in registers.
#define DBL_CHAIN(NAME, NS, N, T)                                           \
  __global__ void __launch_bounds__(256) NAME(uint32_t* io, int iters) {    \
    const int t = blockIdx.x * blockDim.x + threadIdx.x;                    \
    NS::Ext p;                                                              \
    _Pragma("unroll") for (int i = 0; i < N; i++) {                         \
      p.x.v[i] = (T)io[(4 * t) * N + i];                                    \
      p.y.v[i] = (T)io[(4 * t + 1) * N + i];                                \
      p.z.v[i] = (T)io[(4 * t + 2) * N + i];                                \
      p.t.v[i] = (T)io[(4 * t + 3) * N + i];                                \
    }                                                                       \
    _Pragma("unroll 1") for (int it = 0; it < iters; it++) p = NS::dbl(p);  \
    _Pragma("unroll") for (int i = 0; i < N; i++) {                         \
      io[(4 * t) * N + i] = (uint32_t)p.x.v[i];                             \
      io[(4 * t + 1) * N + i] = (uint32_t)p.y.v[i];                         \
      io[(4 * t + 2) * N + i] = (uint32_t)p.z.v[i];                         \
      io[(4 * t + 3) * N + i] = (uint32_t)p.t.v[i];                         \
    }                                                                       \
  }

DBL_CHAIN(fe13_dbl, ed25519, 20, int32_t)
DBL_CHAIN(wide_dbl, ed_wide, 10, uint32_t)

// One fold-4 step per trip: P = 2P, the scan of the 16 entries of `table`
// (WORDS a entry) staged in shared memory, P = P + entry.
#define STEP_CHAIN(NAME, NS, N, T, WORDS, GATHER)                           \
  __global__ void __launch_bounds__(256) NAME(uint32_t* io,                 \
                                              const uint32_t* table,        \
                                              int iters) {                  \
    __shared__ __align__(16) uint32_t tbl[16 * WORDS];                      \
    for (int i = threadIdx.x; i < 16 * WORDS; i += blockDim.x)              \
      tbl[i] = table[i];                                                    \
    __syncthreads();                                                        \
    const int t = blockIdx.x * blockDim.x + threadIdx.x;                    \
    NS::Ext p;                                                              \
    _Pragma("unroll") for (int i = 0; i < N; i++) {                         \
      p.x.v[i] = (T)io[(4 * t) * N + i];                                    \
      p.y.v[i] = (T)io[(4 * t + 1) * N + i];                                \
      p.z.v[i] = (T)io[(4 * t + 2) * N + i];                                \
      p.t.v[i] = (T)io[(4 * t + 3) * N + i];                                \
    }                                                                       \
    _Pragma("unroll 1") for (int it = 0; it < iters; it++) {                \
      p = NS::dbl(p);                                                       \
      NS::Fe ypx, ymx, t2d;                                                 \
      GATHER(ypx, ymx, t2d, tbl, (t + it) & 15);                            \
      p = NS::add_pa(p, ypx, ymx, t2d);                                     \
    }                                                                       \
    _Pragma("unroll") for (int i = 0; i < N; i++) {                         \
      io[(4 * t) * N + i] = (uint32_t)p.x.v[i];                             \
      io[(4 * t + 1) * N + i] = (uint32_t)p.y.v[i];                         \
      io[(4 * t + 2) * N + i] = (uint32_t)p.z.v[i];                         \
      io[(4 * t + 3) * N + i] = (uint32_t)p.t.v[i];                         \
    }                                                                       \
  }

// The wide core's scan of the 16-entry word table (fold_wide.cuh)
FE_HD void wide_scan16(fe_wide::Fe& ypx, fe_wide::Fe& ymx, fe_wide::Fe& t2d,
                       const uint32_t* tbl, int32_t idx) {
  fold_wide::gather(ypx, ymx, t2d, fold_wide::ScanWords<16>{tbl}, idx);
}

STEP_CHAIN(fe13_fold4, ed25519, 20, int32_t, ed25519::kEntryWords,
           ed25519::gather<16>)
STEP_CHAIN(wide_fold4, ed_wide, 10, uint32_t, fold_wide::kWords,
           wide_scan16)

// The gathered canonical words as the 13-bit core's limbs (basemult.cu's
// Limbs13Gather, the fold-8 limb modes)
FE_HD void fe13_words(fe25519::Fe& ypx, fe25519::Fe& ymx, fe25519::Fe& t2d,
                      const gather_mma::Gather& words, int32_t idx) {
  uint32_t w[3][8];
  words(w, idx);
  fe_wide::limbs13_from_words(ypx.v, w[0]);
  fe_wide::limbs13_from_words(ymx.v, w[1]);
  fe_wide::limbs13_from_words(t2d.v, w[2]);
}

// One fold-8 step per trip: P = 2P, the tensor-core gather of entry
// (t + it) & 255 of the fold-8 word table in B order (each lane of a warp
// its own entry), P = P + entry; the table and the warps' staging rows in
// dynamic shared memory.
#define FOLD8_CHAIN(NAME, NS, N, T, GATHER)                                 \
  __global__ void __launch_bounds__(256) NAME(uint32_t* io,                 \
                                              const uint32_t* table,        \
                                              int iters) {                  \
    extern __shared__ __align__(16) uint32_t smem[];                        \
    const gather_mma::Gather words = gather_mma::load_table(smem, table);   \
    const int t = blockIdx.x * blockDim.x + threadIdx.x;                    \
    NS::Ext p;                                                              \
    _Pragma("unroll") for (int i = 0; i < N; i++) {                         \
      p.x.v[i] = (T)io[(4 * t) * N + i];                                    \
      p.y.v[i] = (T)io[(4 * t + 1) * N + i];                                \
      p.z.v[i] = (T)io[(4 * t + 2) * N + i];                                \
      p.t.v[i] = (T)io[(4 * t + 3) * N + i];                                \
    }                                                                       \
    _Pragma("unroll 1") for (int it = 0; it < iters; it++) {                \
      p = NS::dbl(p);                                                       \
      NS::Fe ypx, ymx, t2d;                                                 \
      GATHER(ypx, ymx, t2d, words, (t + it) & 255);                         \
      p = NS::add_pa(p, ypx, ymx, t2d);                                     \
    }                                                                       \
    _Pragma("unroll") for (int i = 0; i < N; i++) {                         \
      io[(4 * t) * N + i] = (uint32_t)p.x.v[i];                             \
      io[(4 * t + 1) * N + i] = (uint32_t)p.y.v[i];                         \
      io[(4 * t + 2) * N + i] = (uint32_t)p.z.v[i];                         \
      io[(4 * t + 3) * N + i] = (uint32_t)p.t.v[i];                         \
    }                                                                       \
  }

FOLD8_CHAIN(fe13_fold8, ed25519, 20, int32_t, fe13_words)
FOLD8_CHAIN(wide_fold8, ed_wide, 10, uint32_t, fold_wide::gather)

// One step of the double-scalar multiply per trip: P = 2P, P = P + entry
// (t + it) & 255 of the fold-8 table, P = P + q_table entry (7t + it) & 15,
// the table (WORDS an entry) and the q_table planes staged in shared memory.
#define POLY_CHAIN(NAME, NS, N, T, WORDS, STEP)                             \
  __global__ void __launch_bounds__(256) NAME(uint32_t* io,                 \
                                              const uint32_t* table,        \
                                              const uint32_t* planes,       \
                                              int iters) {                  \
    __shared__ __align__(16) uint32_t tbl[256 * WORDS];                     \
    __shared__ __align__(16) uint32_t qt[kQtWords];                         \
    for (int i = threadIdx.x; i < 256 * WORDS; i += blockDim.x)             \
      tbl[i] = table[i];                                                    \
    for (int i = threadIdx.x; i < kQtWords; i += blockDim.x)                \
      qt[i] = planes[i];                                                    \
    __syncthreads();                                                        \
    const int t = blockIdx.x * blockDim.x + threadIdx.x;                    \
    NS::Ext p;                                                              \
    _Pragma("unroll") for (int i = 0; i < N; i++) {                         \
      p.x.v[i] = (T)io[(4 * t) * N + i];                                    \
      p.y.v[i] = (T)io[(4 * t + 1) * N + i];                                \
      p.z.v[i] = (T)io[(4 * t + 2) * N + i];                                \
      p.t.v[i] = (T)io[(4 * t + 3) * N + i];                                \
    }                                                                       \
    _Pragma("unroll 1") for (int it = 0; it < iters; it++) {                \
      const int b = (t + it) & 255, e = (7 * t + it) & 15;                  \
      STEP;                                                                 \
    }                                                                       \
    _Pragma("unroll") for (int i = 0; i < N; i++) {                         \
      io[(4 * t) * N + i] = (uint32_t)p.x.v[i];                             \
      io[(4 * t + 1) * N + i] = (uint32_t)p.y.v[i];                         \
      io[(4 * t + 2) * N + i] = (uint32_t)p.z.v[i];                         \
      io[(4 * t + 3) * N + i] = (uint32_t)p.t.v[i];                         \
    }                                                                       \
  }

// The wide step: poly_lane's loop body.
#define WIDE_POLY_STEP                                                      \
  p = ed_wide::dbl(p);                                                      \
  fe_wide::Fe ypx, ymx, t2d;                                                \
  load_base(ypx, ymx, t2d, tbl, b);                                         \
  p = ed_wide::add_pa(p, ypx, ymx, t2d);                                    \
  p = ed_wide::add_pe(ed_wide::ExtReader{p},                                \
                      PlaneEntry{qt + e * kQtEntryWords})

// The 13-bit step: the packed entry unpacked, the q_table entry's 80 limbs
// decoded whole.
#define FE13_POLY_STEP                                                      \
  p = ed25519::dbl(p);                                                      \
  fe25519::Fe ypx, ymx, t2d;                                                \
  uint32_t w[ed25519::kEntryWords];                                         \
  load_words(w, tbl + b * ed25519::kEntryWords);                            \
  ed25519::unpack_pa(ypx, ymx, t2d, w);                                     \
  p = ed25519::add_pa(p, ypx, ymx, t2d);                                    \
  uint32_t pw[kQtEntryWords];                                               \
  load_words(pw, qt + e * kQtEntryWords);                                   \
  int32_t limb[80];                                                         \
  _Pragma("unroll") for (int k = 0; k < 20; k++)                            \
    decode_word(limb + 4 * k, pw[k], pw[20 + k]);                           \
  p = ed25519::add_pe(p, limb)

POLY_CHAIN(fe13_poly, ed25519, 20, int32_t, ed25519::kEntryWords,
           FE13_POLY_STEP)
POLY_CHAIN(wide_poly, ed_wide, 10, uint32_t, kBaseEntryWords,
           WIDE_POLY_STEP)

#define LAUNCH(NAME)                                                        \
  extern "C" int NAME##_launch(void* io, int iters, int blocks, void* s) {  \
    NAME<<<blocks, 256, 0, (cudaStream_t)s>>>((uint32_t*)io, iters);        \
    return (int)cudaGetLastError();                                         \
  }
#define LAUNCHES(CORE) LAUNCH(CORE##_mul) LAUNCH(CORE##_sqr)
LAUNCHES(fe13)
LAUNCHES(wide)
LAUNCHES(w8)
LAUNCH(fe13_dbl)
LAUNCH(wide_dbl)

#define STEP_LAUNCH(NAME)                                                   \
  extern "C" int NAME##_launch(void* io, const void* table, int iters,     \
                               int blocks, void* s) {                      \
    NAME<<<blocks, 256, 0, (cudaStream_t)s>>>((uint32_t*)io,               \
                                              (const uint32_t*)table,      \
                                              iters);                      \
    return (int)cudaGetLastError();                                         \
  }
STEP_LAUNCH(fe13_fold4)
STEP_LAUNCH(wide_fold4)

constexpr int kFold8ChainSmem =
    4 * (gather_mma::kTableWords + 8 * gather_mma::kStageWords);
#define FOLD8_LAUNCH(NAME)                                                  \
  extern "C" int NAME##_launch(void* io, const void* table, int iters,     \
                               int blocks, void* s) {                      \
    const cudaError_t rc = cudaFuncSetAttribute(                            \
        NAME, cudaFuncAttributeMaxDynamicSharedMemorySize, kFold8ChainSmem);\
    if (rc != cudaSuccess) return (int)rc;                                  \
    NAME<<<blocks, 256, kFold8ChainSmem, (cudaStream_t)s>>>(                \
        (uint32_t*)io, (const uint32_t*)table, iters);                     \
    return (int)cudaGetLastError();                                         \
  }
FOLD8_LAUNCH(fe13_fold8)
FOLD8_LAUNCH(wide_fold8)

#define POLY_LAUNCH(NAME)                                                   \
  extern "C" int NAME##_launch(void* io, const void* table,                \
                               const void* planes, int iters, int blocks,  \
                               void* s) {                                   \
    NAME<<<blocks, 256, 0, (cudaStream_t)s>>>((uint32_t*)io,               \
                                              (const uint32_t*)table,      \
                                              (const uint32_t*)planes,     \
                                              iters);                      \
    return (int)cudaGetLastError();                                         \
  }
POLY_LAUNCH(fe13_poly)
POLY_LAUNCH(wide_poly)
"""

# core -> (limbs, the bound of the random limbs that start each chain, its
# chains; "fold4" and "fold8" take the table of their step, "poly" its table
# and a q_table)
CORES = {"fe13": (20, 1 << 13, ("mul", "sqr", "dbl", "fold4", "fold8",
                                "poly")),
         "wide": (10, 1 << 25, ("mul", "sqr", "dbl", "fold4", "fold8",
                                "poly")),
         "w8": (8, 1 << 32, ("mul", "sqr"))}


def nvcc_build(src, out, include=build.CSRC, flags=()):
    """Start nvcc on src into the shared library out; returns the process
    and its log path."""
    log = out.with_suffix(".log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *flags, "-I", str(include),
             "-o", str(out), str(src)], stdout=f, stderr=subprocess.STDOUT)
    return proc, log


def wait_all(jobs):
    """jobs: name -> (process, log). Raises with the log of any failure."""
    for name, (proc, log) in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError("nvcc failed on %s:\n%s" % (name,
                                                            log.read_text()))


def sass_functions(so):
    """Each kernel's SASS instructions in a library (cuobjdump -sass), by its
    (mangled) function name: a list of (address, opcode, branch target or
    None)."""
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    funcs = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        funcs[name] = [
            (int(addr, 16), op, int(target, 16) if target else None)
            for addr, op, target in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                r"([A-Z][A-Z0-9_.]*)(?:\s+(?:0x)?([0-9a-f]+)\s*;)?", chunk)]
    return funcs


def kernel_sass(funcs, kernel):
    """The instructions of the one function named `kernel` (mangled or
    not)."""
    found = [f for name, f in funcs.items()
             if re.search(r"\d%s[A-Z]" % kernel, name) or name == kernel]
    if len(found) != 1:
        raise RuntimeError("%d SASS functions for %s among %s"
                           % (len(found), kernel, sorted(funcs)))
    return found[0]


def opcodes(insts, loop=False):
    """Opcode counts of a function, or (loop=True) of its longest loop: the
    instructions from a backward branch's target to the branch."""
    if loop:
        spans = [(target, addr) for addr, op, target in insts
                 if op == "BRA" and target is not None and target < addr]
        if not spans:
            raise RuntimeError("no loop in this SASS")
        lo, hi = max(spans, key=lambda s: s[1] - s[0])
        insts = [i for i in insts if lo <= i[0] <= hi]
    return Counter(op for _, op, _ in insts)


def summarize(counts):
    wide = sum(n for op, n in counts.items() if op.startswith("IMAD.WIDE"))
    imad = sum(n for op, n in counts.items() if op.startswith("IMAD")) - wide
    alu = sum(n for op, n in counts.items() if op.split(".")[0] in ALU_OPS)
    return {"imad_wide": wide, "imad": imad, "alu": alu,
            "total": sum(counts.values())}


def event_ms(fn, reps=3):
    """Best of `reps` calls of fn by CUDA events, in ms."""
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def load(so, entries, argtypes, lib=None):
    lib = lib or ctypes.CDLL(str(so))
    for name in entries:
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def stream():
    return torch.cuda.current_stream().cuda_stream


def start_cores_build():
    """Start nvcc on the field cores' chain kernels; returns (library,
    (process, log))."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    src = PROBE_DIR / "cores.cu"
    src.write_text(CORES_SRC)
    so = PROBE_DIR / "libcores.so"
    return so, nvcc_build(src, so)


def run_cores(so, log, rng, card, iters=128):
    names = ["%s_%s" % (c, op) for c, (_, _, ops) in CORES.items()
             for op in ops]
    regs = build.parse_ptxas(log.read_text(), names)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    stepped = ("fold4", "fold8")
    lib = load(so, [n + "_launch" for n in names
                    if n.split("_")[1] not in stepped + ("poly",)],
               [vp, i32, i32, vp])
    load(so, [n + "_launch" for n in names if n.split("_")[1] in stepped],
         [vp, vp, i32, i32, vp], lib)
    load(so, [n + "_launch" for n in names if "poly" in n],
         [vp, vp, vp, i32, i32, vp], lib)
    dev = torch.device("cuda")
    tables = {("fe13", "fold4"): edwards_kernel.packed_table(4, dev),
              ("wide", "fold4"): edwards_kernel.word_table(4, dev),
              ("fe13", "fold8"): edwards_kernel.mma_word_table(dev),
              ("wide", "fold8"): edwards_kernel.mma_word_table(dev),
              ("fe13", "poly"): edwards_kernel.packed_table(8, dev),
              ("wide", "poly"): edwards_kernel.word_table(8, dev)}
    # one q_table of canonical limbs: 13-bit limbs below 2^13, the top one
    # below 2^8 (a value below 2^255), as lo and hi planes
    limbs = rng.integers(0, 1 << 13, (16, 4, 20))
    limbs[..., 19] &= 0xFF
    planes = torch.from_numpy(np.concatenate(
        [(limbs & 0x7F).reshape(16, 80), (limbs >> 7).reshape(16, 80)],
        -1).astype(np.int8)).to(dev)
    blocks = BATCH // THREADS
    funcs = sass_functions(so)
    rows = {}
    for core, (nlimbs, bound, ops) in CORES.items():
        init = rng.integers(0, bound, (BATCH, 4, nlimbs), dtype=np.uint64)
        for op in ops:
            name = "%s_%s" % (core, op)
            io = torch.from_numpy(init.astype(np.uint32).view(np.int32)).cuda()
            entry = getattr(lib, name + "_launch")
            head = (io.data_ptr(),)
            if op in ("fold4", "fold8", "poly"):
                head += (tables[core, op].data_ptr(),)
            if op == "poly":
                head += (planes.data_ptr(),)

            def run():
                rc = entry(*head, iters, blocks, stream())
                if rc != 0:
                    raise RuntimeError("%s launch failed: %d" % (name, rc))

            run()
            ms = event_ms(run)
            rows[name] = row = dict(
                summarize(opcodes(kernel_sass(funcs, name), loop=True)),
                registers=regs[name]["registers"],
                spill_store_bytes=regs[name]["spill_store_bytes"],
                ms_per_op=ms / iters)
            print("cores [%s]: %s %s, one trip of its chain: IMAD.WIDE %d, "
                  "other IMAD %d, ALU %d, all %d SASS instructions | %d "
                  "registers, spill %d B | %.4f ms per op (fold4, fold8, "
                  "poly: per step) over %d lanes" % (
                      card, core, op, row["imad_wide"], row["imad"],
                      row["alu"], row["total"], row["registers"],
                      row["spill_store_bytes"], row["ms_per_op"], BATCH))
    return rows


# A checkout's lane function in a kernel of the probe's own, at the block
# size and __launch_bounds__ minimum that the build defines: the ladder's
# (ladder.cu's x25519_lane) and Verify_Init's (verify.cu's
# verify_init_lane).
LADDER_VARIANT = r"""
#include "ladder.cu"

__global__ void __launch_bounds__(PROBE_THREADS, PROBE_MIN_BLOCKS)
probe_ladder_kernel(uint8_t* out, const uint8_t* u, const uint8_t* k,
                    const int32_t* zr, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  x25519_lane(out + 32 * lane, u + 32 * lane, k + 32 * lane,
              zr ? zr + fe25519::NLIMBS * lane : nullptr);
}

extern "C" int probe_ladder_launch(void* out, const void* u, const void* k,
                                   const void* zr, int64_t n, void* stream) {
  probe_ladder_kernel<<<(unsigned)((n + PROBE_THREADS - 1) / PROBE_THREADS),
                        PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      (uint8_t*)out, (const uint8_t*)u, (const uint8_t*)k,
      (const int32_t*)zr, n);
  return (int)cudaGetLastError();
}
"""

VINIT_VARIANT = r"""
#include "verify.cu"

__global__ void __launch_bounds__(PROBE_THREADS, PROBE_MIN_BLOCKS)
probe_vinit_kernel(uint32_t* __restrict__ planes, uint8_t* __restrict__ ok,
                   const uint8_t* __restrict__ pk, int64_t n) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  verify_init_lane(planes + kQtWords * lane, ok + lane, pk + 32 * lane);
}

extern "C" int probe_vinit_launch(void* planes, void* ok, const void* pk,
                                  int64_t n, void* stream) {
  probe_vinit_kernel<<<(unsigned)((n + PROBE_THREADS - 1) / PROBE_THREADS),
                       PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)planes, (uint8_t*)ok, (const uint8_t*)pk, n);
  return (int)cudaGetLastError();
}
"""

FOLD4_VARIANT = r"""
#include "basemult.cu"

#if PROBE_MIN_BLOCKS > 0
#define PROBE_BOUNDS __launch_bounds__(PROBE_THREADS, PROBE_MIN_BLOCKS)
#else
#define PROBE_BOUNDS __launch_bounds__(PROBE_THREADS)
#endif

// basemult_fold4_kernel's body at the probe's block size and minimum
__global__ void PROBE_BOUNDS
probe_fold4_kernel(char* out, const int32_t* __restrict__ cut,
                   const int32_t* __restrict__ zr, int64_t zr_stride,
                   const int32_t* __restrict__ bp, int64_t bp_stride,
                   const uint32_t* __restrict__ table, int mode, int64_t n) {
  constexpr int kTableWords = 16 * fold_wide::kWords;
  __shared__ __align__(16) uint32_t tbl[kTableWords];
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x)
    tbl[i] = table[i];
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  fold_wide::lane<64>((uint8_t*)out + 32 * lane, cut + 64 * lane,
                      zr ? zr + zr_stride * lane : nullptr,
                      bp ? bp + bp_stride * lane : nullptr, mode == MODE_PK,
                      fold_wide::ScanWords<16>{tbl});
}

// basemult_launch's arguments, for the byte modes of fold 4
extern "C" int probe_fold4_launch(void* out, const void* cut, const void* zr,
                                  int64_t zr_stride, const void* bp,
                                  int64_t bp_stride, const void* table,
                                  int nfolds, int mode, int64_t n,
                                  void* stream) {
  probe_fold4_kernel<<<(unsigned)((n + PROBE_THREADS - 1) / PROBE_THREADS),
                       PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      (char*)out, (const int32_t*)cut, (const int32_t*)zr, zr_stride,
      (const int32_t*)bp, bp_stride, (const uint32_t*)table, mode, n);
  return (int)cudaGetLastError();
}
"""

POLY_VARIANT = r"""
#include "poly.cu"

#if PROBE_MIN_BLOCKS > 0
#define PROBE_BOUNDS __launch_bounds__(PROBE_THREADS, PROBE_MIN_BLOCKS)
#else
#define PROBE_BOUNDS __launch_bounds__(PROBE_THREADS)
#endif

// poly_kernel's body at the probe's block size and minimum (0: none)
__global__ void PROBE_BOUNDS
probe_poly_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ u,
                  const int32_t* __restrict__ v,
                  const uint32_t* __restrict__ planes,
                  const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kBaseWords];
  copy_shared(tbl, table, kBaseWords);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane,
            planes + kQtWords * lane, tbl);
}

// poly_launch's arguments, per-lane q_tables only
extern "C" int probe_poly_launch(void* out, const void* u, const void* v,
                                 const void* planes, int shared,
                                 const void* table, int64_t n, void* stream) {
  probe_poly_kernel<<<(unsigned)((n + PROBE_THREADS - 1) / PROBE_THREADS),
                      PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      (uint8_t*)out, (const int32_t*)u, (const int32_t*)v,
      (const uint32_t*)planes, (const uint32_t*)table, n);
  return (int)cudaGetLastError();
}
"""

ONESHOT_VARIANT = r"""
#include "oneshot.cu"

// oneshot_kernel's body at the probe's block size and minimum; its grid is
// rows / PROBE_THREADS blocks, persistent where that is fewer than the
// tiles. PROBE_BARRIER: 0, none; 1, the block's threads meet after each
// phase of a tile; 2, after Verify_Init only (as the shipped kernel).
// PROBE_BALANCED: block b takes the lanes [n b / grid, n (b + 1) / grid) in
// tiles, in place of every grid-th tile.
__global__ void __launch_bounds__(PROBE_THREADS, PROBE_MIN_BLOCKS)
probe_oneshot_kernel(uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
                     uint32_t* __restrict__ scratch,
                     const uint8_t* __restrict__ pk,
                     const int32_t* __restrict__ u,
                     const int32_t* __restrict__ v,
                     const uint32_t* __restrict__ table, int64_t n) {
  __shared__ __align__(16) uint32_t tbl[kBaseWords];
  for (int c = threadIdx.x; c < kBaseWords / 4; c += blockDim.x)
    reinterpret_cast<uint4*>(tbl)[c] =
        reinterpret_cast<const uint4*>(table)[c];
  __syncthreads();
  uint32_t* row = scratch +
      kQtWords * ((int64_t)blockIdx.x * PROBE_THREADS + threadIdx.x);
#if PROBE_BALANCED
  const int64_t lo = n * blockIdx.x / gridDim.x;
  const int64_t hi = n * (blockIdx.x + 1) / gridDim.x;
  const int64_t step = PROBE_THREADS;
#else
  const int64_t lo = (int64_t)blockIdx.x * PROBE_THREADS, hi = n;
  const int64_t step = (int64_t)gridDim.x * PROBE_THREADS;
#endif
#pragma unroll 1
  for (int64_t tile = lo; tile < hi; tile += step) {
    const int64_t lane = tile + threadIdx.x;
    const bool live = lane < hi;
    if (live) verify_init_lane(row, ok + lane, pk + 32 * lane);
#if PROBE_BARRIER
    __syncthreads();
#endif
    if (live)
      poly_lane(out + 32 * lane, u + 32 * lane, v + 64 * lane, row, tbl);
#if PROBE_BARRIER == 1
    __syncthreads();
#endif
  }
}

// oneshot_launch's arguments; rows: probe_oneshot_rows's
extern "C" int probe_oneshot_launch(void* out, void* ok, void* scratch,
                                    int64_t rows, const void* pk,
                                    const void* u, const void* v,
                                    const void* table, int64_t n,
                                    void* stream) {
  probe_oneshot_kernel<<<(unsigned)(rows / PROBE_THREADS), PROBE_THREADS, 0,
                         (cudaStream_t)stream>>>(
      (uint8_t*)out, (uint8_t*)ok, (uint32_t*)scratch, (const uint8_t*)pk,
      (const int32_t*)u, (const int32_t*)v, (const uint32_t*)table, n);
  return (int)cudaGetLastError();
}

// Scratch rows of the grid: PROBE_GRID_PER_SM blocks per SM, or (0) one
// block per tile of PROBE_THREADS lanes
extern "C" int probe_oneshot_rows(int64_t n, int sms) {
  const int64_t blocks = (n + PROBE_THREADS - 1) / PROBE_THREADS;
  const int64_t most = (int64_t)PROBE_GRID_PER_SM * sms;
  return (int)(PROBE_GRID_PER_SM == 0 || blocks < most ? blocks : most) *
         PROBE_THREADS;
}
"""

# what -> (its source in csrc/, launch entry, kernel, the probe's variant
# source, the probe's launch entry and kernel)
KERNELS = {
    "ladder": ("ladder.cu", "x25519_ladder_launch", "x25519_ladder_kernel",
               LADDER_VARIANT, "probe_ladder_launch", "probe_ladder_kernel"),
    "vinit": ("verify.cu", "verify_init_launch", "verify_init_kernel",
              VINIT_VARIANT, "probe_vinit_launch", "probe_vinit_kernel"),
    "fold4": ("basemult.cu", "basemult_launch", "basemult_fold4_kernel",
              FOLD4_VARIANT, "probe_fold4_launch", "probe_fold4_kernel"),
    "poly": ("poly.cu", "poly_launch", "poly_kernel", POLY_VARIANT,
             "probe_poly_launch", "probe_poly_kernel"),
    "oneshot": ("oneshot.cu", "oneshot_launch", "oneshot_kernel",
                ONESHOT_VARIANT, "probe_oneshot_launch",
                "probe_oneshot_kernel"),
}


def probe_builds(what, variants, parent):
    """Start one nvcc per build of a kernel: the checkout's source as it
    ships, each (threads, min_blocks[, extra...]) variant (extra: fold 4's
    FOLD4_SCAN_UNROLL, entries per trip of its scan; the one-shot grid's
    blocks per SM, default min_blocks, its barriers and its balanced
    split, ONESHOT_VARIANT's PROBE_BARRIER and PROBE_BALANCED), and the
    parent's source.
    Returns name -> (library, launch entry, kernel, (process, log))."""
    src, entry, kernel, variant, probe_entry, probe_kernel = KERNELS[what]
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    variant_src = PROBE_DIR / ("%s_variant.cu" % what)
    variant_src.write_text(variant)
    jobs = {}
    sources = [("shipped", build.CSRC)]
    if parent is not None:
        sources.append(("parent", Path(parent) / "curve25519_tpu_torch"
                        "/ops/cuda/csrc"))
    for name, csrc in sources:
        so = PROBE_DIR / ("lib%s_%s.so" % (what, name))
        jobs[name] = (so, entry, kernel,
                      nvcc_build(csrc / src, so, include=csrc))
    for threads, min_blocks, *unroll in variants:
        name = "%s_t%d_m%d" % (what, threads, min_blocks)
        flags = ["-DPROBE_THREADS=%d" % threads,
                 "-DPROBE_MIN_BLOCKS=%d" % min_blocks]
        if what == "oneshot":
            per_sm, barrier, balanced = list(unroll) + [min_blocks, 0, 0][
                len(unroll):]
            name += "_g%d_b%d%s" % (per_sm, barrier, "_bal" if balanced
                                    else "")
            flags += ["-DPROBE_GRID_PER_SM=%d" % per_sm,
                      "-DPROBE_BARRIER=%d" % barrier,
                      "-DPROBE_BALANCED=%d" % balanced]
        elif unroll:
            name += "_u%d" % unroll[0]
            flags.append("-DFOLD4_SCAN_UNROLL=%d" % unroll[0])
        so = PROBE_DIR / ("lib%s.so" % name)
        jobs[name] = (so, probe_entry, probe_kernel,
                      nvcc_build(variant_src, so, flags=flags))
    return jobs


def run_in_turns(what, jobs, argtypes, make_outputs, args_of, card):
    """Launch every build of `jobs` once (make_outputs() gives a build its
    output tensors, args_of(name, outputs) the launch's arguments before the
    stream), hold all outputs equal, then time the builds in turns. Each
    row: ptxas's report, the SASS opcodes of the whole kernel and of its
    longest loop, and the times."""
    launches, rows, outs = {}, {}, {}
    for name, (so, entry, kernel, (_, log)) in jobs.items():
        info = build.parse_ptxas(log.read_text(), [kernel])
        insts = kernel_sass(sass_functions(so), kernel)
        rows[name] = dict(info[kernel],
                          **summarize(opcodes(insts)),
                          loop=summarize(opcodes(insts, loop=True)), ms=[])
        launches[name] = fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        outs[name] = make_outputs()
        rc = fn(*args_of(name, outs[name]), stream())
        if rc != 0:
            raise RuntimeError("%s launch failed: %d" % (name, rc))
        torch.cuda.synchronize()
    first = next(iter(outs))
    for name, out in outs.items():
        if not all(torch.equal(a, b) for a, b in zip(out, outs[first])):
            raise RuntimeError("%s's bytes differ from %s's" % (name, first))
    order = list(launches)
    for _ in range(ROUNDS):
        for name in order + order[::-1]:
            args, fn = args_of(name, outs[name]), launches[name]
            rows[name]["ms"].append(event_ms(lambda: fn(*args, stream())))
    for name, row in rows.items():
        row["best_ms"] = min(row["ms"])
        loop = row["loop"]
        print("%s [%s]: %s %d registers, spill %d/%d B, stack %d B | SASS "
              "IMAD.WIDE %d, other IMAD %d, ALU %d, all %d; its longest "
              "loop %d, %d, %d, %d | best %.3f ms of %s, B=%d"
              % (what, card, name, row["registers"],
                 row["spill_store_bytes"], row["spill_load_bytes"],
                 row["stack_bytes"], row["imad_wide"], row["imad"],
                 row["alu"], row["total"], loop["imad_wide"], loop["imad"],
                 loop["alu"], loop["total"], row["best_ms"],
                 ", ".join("%.3f" % t for t in row["ms"]), BATCH))
    return rows


def run_ladders(jobs, rng, card):
    """The ladder builds on random u and clamped keys (the longest loop is
    one ladder step)."""
    u = torch.from_numpy(rng.integers(0, 256, (BATCH, 32), np.uint8)).cuda()
    k = rng.integers(0, 256, (BATCH, 32), np.uint8)
    k[:, 0] &= 248
    k[:, 31] = (k[:, 31] & 127) | 64
    k = torch.from_numpy(k).cuda()
    return run_in_turns(
        "ladder", jobs, [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                                 ctypes.c_void_p],
        lambda: (torch.empty_like(u),),
        lambda name, out: (out[0].data_ptr(), u.data_ptr(), k.data_ptr(),
                           None, BATCH), card)


def run_vinits(jobs, rng, card):
    """The Verify_Init builds on random 32-byte keys, about half of them off
    the curve (the longest loop is the one over the three bases)."""
    pk = torch.from_numpy(rng.integers(0, 256, (BATCH, 32), np.uint8)).cuda()
    return run_in_turns(
        "vinit", jobs, [ctypes.c_void_p] * 3 + [ctypes.c_int64,
                                                ctypes.c_void_p],
        lambda: (torch.empty((BATCH, 16, 160), dtype=torch.int8,
                             device="cuda"),
                 torch.empty(BATCH, dtype=torch.bool, device="cuda")),
        lambda name, out: (out[0].data_ptr(), out[1].data_ptr(),
                           pk.data_ptr(), BATCH), card)


def run_fold4s(jobs, parent, rng, card):
    """The fold-4 builds in the "u_bytes" mode on the digits of random
    clamped scalars, no zr and no BP (the longest loop is one step). A build
    gets the table its launch reads: the word table, or the packed table for
    a parent whose basemult_fold4_kernel ran every mode on the 13-bit lane
    (one with no basemult_fold4_limbs_kernel)."""
    dev = torch.device("cuda")
    sk = torch.from_numpy(rng.integers(0, 256, (BATCH, 32), np.uint8))
    cut = fold.cut4_bytes(codec.clamp(sk.to(dev))).contiguous()
    mode = edwards_kernel.MODES["u_bytes"]
    tables = {name: edwards_kernel.word_table(4, dev) for name in jobs}
    if parent is not None and "basemult_fold4_limbs_kernel" not in (
            Path(parent) / "curve25519_tpu_torch/ops/cuda/csrc/basemult.cu"
            ).read_text():
        tables["parent"] = edwards_kernel.packed_table(4, dev)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    return run_in_turns(
        "fold4", jobs, [vp, vp, vp, i64, vp, i64, vp, i32, i32, i64, vp],
        lambda: (torch.empty((BATCH, 32), dtype=torch.uint8, device=dev),),
        lambda name, out: (out[0].data_ptr(), cut.data_ptr(), None, 0, None,
                           0, tables[name].data_ptr(), 4, mode, BATCH), card)


def parent_reads_packed(parent):
    """Whether the parent's poly.cu reads the packed fold-8 table (the
    13-bit lane's) rather than the word table."""
    return parent is not None and "PlainPa" in (
        Path(parent) / "curve25519_tpu_torch/ops/cuda/csrc/poly.cu"
    ).read_text()


def verify_inputs(vinits, rng):
    """Random keys (about half off the curve), their planes from the
    checkout's Verify_Init, and random digits u (mod 256) and v (mod 16)."""
    dev = torch.device("cuda")
    pk = torch.from_numpy(rng.integers(0, 256, (BATCH, 32), np.uint8)).to(dev)
    planes = torch.empty((BATCH, 16, 160), dtype=torch.int8, device=dev)
    ok = torch.empty(BATCH, dtype=torch.bool, device=dev)
    so, entry = vinits["shipped"][:2]
    fn = load(so, [entry], [ctypes.c_void_p] * 3 + [ctypes.c_int64,
                                                    ctypes.c_void_p])
    if getattr(fn, entry)(planes.data_ptr(), ok.data_ptr(), pk.data_ptr(),
                          BATCH, stream()) != 0:
        raise RuntimeError("verify_init_launch failed")
    u = torch.from_numpy(rng.integers(0, 256, (BATCH, 32), np.int32)).to(dev)
    v = torch.from_numpy(rng.integers(0, 16, (BATCH, 64), np.int32)).to(dev)
    return pk, planes, u, v


def verify_tables(jobs, parent):
    """The fold-8 table each build reads: the word table, or the packed
    table for a parent on the 13-bit lane."""
    dev = torch.device("cuda")
    tables = {name: edwards_kernel.word_table(8, dev) for name in jobs}
    if parent_reads_packed(parent):
        tables["parent"] = edwards_kernel.packed_table(8, dev)
    return tables


def run_polys(jobs, parent, inputs, card):
    """The double-scalar multiply builds on per-lane q_tables (the longest
    loop is one step)."""
    _, planes, u, v = inputs
    tables = verify_tables(jobs, parent)
    vp = ctypes.c_void_p
    return run_in_turns(
        "poly", jobs, [vp] * 4 + [ctypes.c_int, vp, ctypes.c_int64, vp],
        lambda: (torch.empty((BATCH, 32), dtype=torch.uint8, device="cuda"),),
        lambda name, out: (out[0].data_ptr(), u.data_ptr(), v.data_ptr(),
                           planes.data_ptr(), 0, tables[name].data_ptr(),
                           BATCH), card)


def run_oneshots(jobs, parent, inputs, card):
    """The one-shot builds: each gets the scratch rows its library sizes
    (the longest loop is the loop over a block's tiles)."""
    pk, _, u, v = inputs
    tables = verify_tables(jobs, parent)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for name, (so, entry, _, _) in jobs.items():
        lib = ctypes.CDLL(str(so))
        size = (lib.oneshot_scratch_rows if entry == "oneshot_launch"
                else lib.probe_oneshot_rows)
        size.argtypes = [ctypes.c_int64, ctypes.c_int]
        size.restype = ctypes.c_int
        rows[name] = size(BATCH, sms)
    scratch = torch.empty((max(rows.values()), 16, 160), dtype=torch.int8,
                          device="cuda")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    return run_in_turns(
        "oneshot", jobs, [vp, vp, vp, i64, vp, vp, vp, vp, i64, vp],
        lambda: (torch.empty((BATCH, 32), dtype=torch.uint8, device="cuda"),
                 torch.empty(BATCH, dtype=torch.bool, device="cuda")),
        lambda name, out: (out[0].data_ptr(), out[1].data_ptr(),
                           scratch.data_ptr(), rows[name], pk.data_ptr(),
                           u.data_ptr(), v.data_ptr(),
                           tables[name].data_ptr(), BATCH), card)


# Builds of a checkout's source as it ships with its launch-shape macros set
# (a variant's numbers, in this order): what -> (its source in csrc/, the
# macros).
SHAPES = {
    "fold8": ("basemult.cu", ("FOLD8_BLOCK", "FOLD8_MIN_BLOCKS")),
    "sign": ("sign.cu", ("SIGN_BLOCK", "SIGN_MIN_BLOCKS")),
}


def shape_builds(what, variants):
    """Start one nvcc per build of SHAPES[what]'s source: as it ships, and
    with each variant's macros set. Returns name -> (library, (process,
    log))."""
    src, macros = SHAPES[what]
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for values in [()] + list(variants):
        name = "%s_shipped" % what
        if values:
            name = "%s_t%d_m%d" % ((what,) + tuple(values))
        flags = ["-D%s=%d" % mv for mv in zip(macros, values)]
        so = PROBE_DIR / ("lib%s.so" % name)
        jobs[name] = (so, nvcc_build(build.CSRC / src, so, flags=flags))
    return jobs


def run_fold8s(builds, rng, card):
    """The fold-8 byte-mode builds in the "u_bytes" mode of
    calculate_public_key_fast on the digits of random clamped scalars, no zr
    and no BP (the longest loop is one step)."""
    dev = torch.device("cuda")
    sk = torch.from_numpy(rng.integers(0, 256, (BATCH, 32), np.uint8))
    cut = fold.cut8_bytes(codec.clamp(sk.to(dev))).contiguous()
    table = edwards_kernel.mma_word_table(dev)
    mode = edwards_kernel.MODES["u_bytes"]
    jobs = {name: (so, "basemult_launch", "basemult_fold8_kernel", job)
            for name, (so, job) in builds.items()}
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    return run_in_turns(
        "fold8", jobs, [vp, vp, vp, i64, vp, i64, vp, i32, i32, i64, vp],
        lambda: (torch.empty((BATCH, 32), dtype=torch.uint8, device=dev),),
        lambda name, out: (out[0].data_ptr(), cut.data_ptr(), None, 0, None,
                           0, table.data_ptr(), 8, mode, BATCH), card)


def run_signs(builds, rng, card):
    """The sign.cu builds: keygen_kernel on random seeds, then sign_kernel on
    64-byte messages under those keys, both with the default zr and no
    blinding, as the API's main paths call them (each longest loop is one
    fold step)."""
    from curve25519_tpu_torch.models import blinding
    from curve25519_tpu_torch.ops import sha512
    dev = torch.device("cuda")
    sk = torch.from_numpy(rng.integers(0, 256, (BATCH, 32), np.uint8)).to(dev)
    msg = torch.from_numpy(rng.integers(0, 256, (BATCH, 64), np.uint8)).to(dev)
    lengths = torch.full((BATCH,), 64, dtype=torch.int32, device=dev)
    zr = blinding.default_zr(device=dev)
    table = edwards_kernel.mma_word_table(dev)
    (w2, nb2, _), (w3, nb3, _) = (
        sha512.pack_words(msg, lengths, prefix=msg.new_zeros(BATCH, hole))
        for hole in (32, 64))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    pk = torch.empty((BATCH, 32), dtype=torch.uint8, device=dev)
    rows = {"keygen": run_in_turns(
        "keygen", {name: (so, "keygen_launch", "keygen_kernel", job)
                   for name, (so, job) in builds.items()},
        [vp, vp, vp, i64, vp, i64, vp, i64, vp, i64, vp],
        lambda: (pk,),
        lambda name, out: (out[0].data_ptr(), sk.data_ptr(), zr.data_ptr(),
                           0, None, 0, None, 0, table.data_ptr(), BATCH),
        card)}
    priv = torch.cat([sk, pk], -1)
    rows["sign"] = run_in_turns(
        "sign", {name: (so, "sign_launch", "sign_kernel", job)
                 for name, (so, job) in builds.items()},
        [vp, vp, vp, i64, vp, vp, i64, vp, vp, i64, vp, i64, vp, i64, vp, i64,
         vp],
        lambda: (torch.empty((BATCH, 64), dtype=torch.uint8, device=dev),),
        lambda name, out: (out[0].data_ptr(), priv.data_ptr(), w2.data_ptr(),
                           w2.shape[1], nb2.data_ptr(), w3.data_ptr(),
                           w3.shape[1], nb3.data_ptr(), zr.data_ptr(), 0,
                           None, 0, None, 0, table.data_ptr(), BATCH), card)
    return rows


# the parts of a run, in order
PARTS = ("cores", "ladder", "vinit", "fold4", "poly", "oneshot", "fold8",
         "sign")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout whose "
                    "ladder.cu, verify.cu, basemult.cu, poly.cu and "
                    "oneshot.cu are timed beside this one's")
    ap.add_argument("--variants", default="64:1,128:4",
                    help="threads:min_blocks builds of this checkout's "
                    "ladder lane")
    ap.add_argument("--vinit-variants", default="128:3,64:6,256:2",
                    help="threads:min_blocks builds of this checkout's "
                    "Verify_Init lane")
    ap.add_argument("--fold4-variants", default="128:4:2,128:4:1,256:2:1",
                    help="threads:min_blocks[:unroll] builds of this "
                    "checkout's fold-4 byte-mode lane (0: no minimum; "
                    "unroll: entries per trip of its scan)")
    ap.add_argument("--poly-variants", default="128:4,256:2",
                    help="threads:min_blocks builds of this checkout's "
                    "double-scalar multiply lane (0: no minimum)")
    ap.add_argument("--oneshot-variants", default="512:1:1:1,256:2:2:2",
                    help="threads:min_blocks[:blocks per SM of the grid"
                    "[:barrier[:balanced]]] builds of this checkout's "
                    "one-shot lane (grid 0: a block per tile; barrier 0: "
                    "none, 1: the block meets after each phase, 2: after "
                    "Verify_Init only; balanced 1: each block a contiguous "
                    "share of the lanes)")
    ap.add_argument("--fold8-variants", default="128:4,256:2",
                    help="threads:min_blocks builds of this checkout's "
                    "basemult.cu (FOLD8_BLOCK, FOLD8_MIN_BLOCKS)")
    ap.add_argument("--sign-variants", default="128:4,128:2",
                    help="threads:min_blocks builds of this checkout's "
                    "sign.cu (SIGN_BLOCK, SIGN_MIN_BLOCKS)")
    ap.add_argument("--only", default=",".join(PARTS),
                    help="the parts to run, of %s" % ",".join(PARTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ladder_probe needs a CUDA card")

    def pairs(text):
        return [tuple(int(x) for x in v.split(":")) for v in text.split(",")]

    only = args.only.split(",")
    if set(only) - set(PARTS):
        raise SystemExit("unknown parts: %s" % sorted(set(only) - set(PARTS)))
    card = card_line()
    print(card)
    rng = np.random.default_rng(25519)
    t0 = time.perf_counter()
    variants = {"ladder": args.variants, "vinit": args.vinit_variants,
                "fold4": args.fold4_variants, "poly": args.poly_variants,
                "oneshot": args.oneshot_variants}
    builds = {what: probe_builds(what, pairs(variants[what]), args.parent)
              for what in KERNELS if what in only}
    shapes = {"fold8": args.fold8_variants, "sign": args.sign_variants}
    shaped = {what: shape_builds(what, pairs(shapes[what]))
              for what in SHAPES if what in only}
    if "poly" in only or "oneshot" in only:      # their planes come from it
        builds.setdefault("vinit", probe_builds("vinit", [], None))
    jobs = {"%s %s" % (what, n): j[3] for what, js in builds.items()
            for n, j in js.items()}
    jobs.update({"%s %s" % (what, n): j[1] for what, js in shaped.items()
                 for n, j in js.items()})
    if "cores" in only:
        so, job = start_cores_build()
        jobs["cores"] = job
    wait_all(jobs)
    print("probe builds: %.1f s wall" % (time.perf_counter() - t0))
    result = {"card": card, "batch": BATCH}
    if "cores" in only:
        result["cores"] = run_cores(so, job[1], rng, card)
    if "ladder" in only:
        result["ladders"] = run_ladders(builds["ladder"], rng, card)
    if "vinit" in only:
        result["vinits"] = run_vinits(builds["vinit"], rng, card)
    if "fold4" in only:
        result["fold4s"] = run_fold4s(builds["fold4"], args.parent, rng,
                                      card)
    if "poly" in only or "oneshot" in only:
        inputs = verify_inputs(builds["vinit"], rng)
    if "poly" in only:
        result["polys"] = run_polys(builds["poly"], args.parent, inputs, card)
    if "oneshot" in only:
        result["oneshots"] = run_oneshots(builds["oneshot"], args.parent,
                                          inputs, card)
    if "fold8" in only:
        result["fold8s"] = run_fold8s(shaped["fold8"], rng, card)
    if "sign" in only:
        result["signs"] = run_signs(shaped["sign"], rng, card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
