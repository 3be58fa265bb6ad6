#!/usr/bin/env python3
"""Smoke run of the PyTorch port (curve25519_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc
(/usr/local/cuda or CUDA_HOME) and PyTorch built for CUDA. It imports
nothing of JAX or of the JAX package. Phases, each printing a line:

1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
2. the nvcc build of every CUDA kernel from csrc/ (one nvcc process per
   source, all at once), with build seconds, registers per thread and spill
   and stack bytes per kernel;
3. the X25519 ladder kernel against its plain PyTorch version on the card,
   byte for byte: random lanes, the RFC 7748 edge u values, an all-zero peer,
   a nonzero zr, ragged batches, rank-1 and broadcast calls;
4. X25519 known answers: RFC 7748 5.2 and 6.1 vectors, and random lanes
   against an independent Python-integer X25519;
5. the X25519 main path at full size: 262,144 lanes of key exchange through
   models.x25519, which must agree on every lane and must have launched the
   kernel; then create_shared_key timed against the plain version;
6. the base-multiply, SHA-512, keygen and sign kernels against their plain
   versions, byte for byte: 4,096 random lanes, ragged batches, rank-1 and
   broadcast calls, fold 8 and fold 4 with all four base-multiply modes (fold
   8 also at every ragged size), the blinded routes (which must not change a
   byte; keygen and sign also at every ragged size), SHA-512 at the padding edges and sign at the fused cap (943/944-byte
   messages);
7. Ed25519 known answers: RFC 8032 7.1 TEST 1-3, SHA-512 against hashlib,
   and random lanes (short and long messages) against an independent
   Python-integer Ed25519;
8. the Ed25519 paths at full size, each driven with every launch count set
   to 0 just before it and read just after: keygen, sign of 64-byte
   messages, the same sign blinded, calculate_public_key_fast with fold 8
   and fold 4 (held equal to the ladder's calculate_public_key on all
   lanes), sha512 of 64-byte messages, and the long-message sign (1,024
   lanes, 944-4,096 bytes); then each kernel timed against its plain
   version at the same batch, and SHA-512 of 1,024 messages of up to 1 MiB
   (the reference's sha512_long shape) against hashlib on a few lanes;
9. the three verify kernels against their plain versions, byte for byte:
   4,096 lanes of valid, random (half of them off the curve) and edge keys,
   Verify_Init, the double-scalar multiply with a q_table per lane and with
   one shared q_table, the one-shot kernel, ragged, rank-1 and broadcast
   calls; then verify, verify_check (per-lane and shared) against the
   table-free plain oracle on signatures of ragged messages up to 1,200
   bytes (over 8 SHA-512 blocks), valid and tampered;
10. verify known answers: RFC 8032 TEST 1-3 and their tampered forms, the
   16 edge-encoding vectors of tests/test_edge_encodings.py rebuilt here on
   Python integers (strict and not), and random lanes against an
   independent Python-integer verify;
11. the verify paths at full size (262,144 distinct keys, 64-byte
   messages), each driven with the launch counts set to 0 just before it
   and read just after: verify_init, verify_check against that context,
   verify_check of one key's signatures against its unbatched context, and
   the one-shot verify; every valid lane must verify and every tampered lane
   fail; then each verify kernel timed against its plain version;
12. the rest of the single-device API on the card: sign_ragged and
   verify_ragged of 65,536 messages of 0-1,200 bytes (10 SHA-512 block
   buckets, both sign routes), each driven with the launch counts set to 0
   just before it and read just after (Verify_Init once per batch, none
   given a context; a rank-1 key takes the shared q_table), held against
   the padded-batch sign, the Python-integer oracle and the tampered lanes,
   then timed (the host's bucket packing alone, and a device profile); the
   OO wrapper's card route against its host-core route, with the single-op
   latency of each (median of 50 calls) and a profile of each card op; the
   streaming Sha512 on the host core (64 MiB) and on the card, against
   hashlib; sc.inv, to_mont / mont_mul / from_mont and exp_mod_bpo at 4,096
   lanes against Python integers; a verify context of 16,384 keys saved and
   loaded; and the custom tool's test vector (`t`) on the card;
13. the multi-device path (parallel/mesh.py): mixed_throughput_step over
   make_pod_mesh() in this process, with a real NCCL process group at the
   world size of one process, at 262,144 lanes of 64-byte messages, driven
   with the launch counts set to 0 just before it and read just after
   (per shard: 4 ladder, 1 keygen, 1 sign, 1 SHA-512, 1 one-shot verify);
   both counters must be 2B and shared_a the bytes of create_shared_key
   run outside the mesh; the warm step timed against the same seven calls
   made without the mesh, and profiled; then two worker processes sharing the card in a
   gloo group (tests/torch_mp_worker.py, 2 x 4,096 lanes), whose shards
   must be the single-process bytes; then the three examples/torch_*.py as
   subprocesses, each of which must exit 0.

It prints the run's wall time, a JSON line of the kernels, the card line,
then, as its last line, {"ok": true, "device": {...}}. Any failed check
exits non-zero before that.
"""

import hashlib
import importlib.util
import json
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 7748
MAIN_BATCH = 262_144          # the batch of bench.py's headline
CHECK_LANES = 4096
ORACLE_LANES = 4
LONG_LANES = 1024             # the long-message sign route
LONG_SHA_LANES = 1024         # the long-message SHA-512 row (1 MiB each)
CSRC = "curve25519_tpu_torch/ops/cuda/csrc/"
VERIFY_LANES = 512             # phase 9's signatures of ragged messages
RAGGED_MSGS = 65_536          # phase 12: messages of 0-1,200 bytes
RAGGED_MAX = 1200
CTX_KEYS = 16_384             # phase 12: the saved verify context
SC_LANES = 4096               # phase 12: the mod-l selftest ops
OO_CALLS = 50                 # phase 12: calls per single-op latency
MP_LANES = 2 * 4096           # phase 13: lanes of the two gloo ranks
SUBPROCESS_TIMEOUT = 300      # phase 13: seconds for a worker or an example
# phase 13: the examples and their arguments
EXAMPLES = (("torch_dh_exchange.py",), ("torch_streaming_and_ragged.py",),
            ("torch_throughput_server.py", "3"))
PALLAS = "curve25519_tpu/ops/pallas/"
# kernel -> (source, the TPU kernel body it replaces, its entry functions in
# ptxas's report)
KERNELS = {
    "x25519_ladder_kernel": ("ladder.cu", PALLAS + "ladder_kernel.py:30",
                             ("x25519_ladder_kernel",)),
    "basemult_kernel": ("basemult.cu", PALLAS + "edwards_kernel.py:143",
                        ("basemult_fold8_kernel", "basemult_fold4_kernel")),
    "sha512_kernel": ("sha512.cu", PALLAS + "sha512_kernel.py:101",
                      ("sha512_kernel",)),
    "keygen_kernel": ("sign.cu", PALLAS + "sign_kernel.py:183",
                      ("keygen_kernel",)),
    "sign_kernel": ("sign.cu", PALLAS + "sign_kernel.py:214",
                    ("sign_kernel",)),
    "verify_init_kernel": ("verify.cu", PALLAS + "verify_kernel.py:218",
                           ("verify_init_kernel",)),
    "poly_kernel": ("poly.cu", PALLAS + "verify_kernel.py:85",
                    ("poly_kernel",)),
    "poly_shared_kernel": ("poly.cu", PALLAS + "verify_kernel.py:85",
                           ("poly_shared_kernel",)),
    "oneshot_kernel": ("oneshot.cu", PALLAS + "verify_kernel.py:320",
                       ("oneshot_kernel",)),
}

P = 2**255 - 19
ELL = 2**252 + 27742317777372353535851937790883648493

# RFC 7748 5.2 and 6.1 vectors (the same constants as tests/test_x25519.py)
V1_K = "a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4"
V1_U = "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c"
V1_OUT = "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"
V2_K = "4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d"
V2_U = "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493"
V2_OUT = "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"
A_SK = "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"
A_PK = "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
B_SK = "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb"
B_PK = "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
SHARED = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"

# RFC 8032 7.1 TEST 1-3 (sk, pk, msg, sig), the constants of
# tests/test_ed25519.py
ED_VECS = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]

# benchmarks/tpu_vectors.py x25519_edge_u: u values with key 0x07 * 32
EDGE_U = [0, 1, P, P + 1, 2**255 - 1, 1 | 1 << 255]
SHA_LENGTHS = [0, 1, 111, 112, 127, 128, 129, 239, 240]
# ragged batch sizes: one lane, partial warps (31, 33), partial blocks
RAGGED = (1, 31, 33, 127, 129, 1000)


def fail(msg):
    raise SystemExit("chip_smoke FAILED: " + msg)


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# Independent oracles on Python integers (no code shared with the port)
# ---------------------------------------------------------------------------
def oracle_x25519(k: bytes, u: bytes) -> bytes:
    """RFC 7748 section 5 X25519 on Python integers."""
    k = bytearray(k)
    k[0] &= 248
    k[31] = (k[31] & 127) | 64
    k = int.from_bytes(k, "little")
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    x2, z2, x3, z3, swap = 1, 0, x1, 1, 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        swap ^= kt
        if swap:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = kt
        a, b = x2 + z2, x2 - z2
        aa, bb = a * a % P, b * b % P
        e = aa - bb
        c, d = x3 + z3, x3 - z3
        da, cb = d * a % P, c * b % P
        x3, z3 = (da + cb) ** 2 % P, x1 * (da - cb) ** 2 % P
        x2, z2 = aa * bb % P, e * (aa + 121665 * e) % P
    if swap:
        x2, z2 = x3, z3
    return (x2 * pow(z2, P - 2, P) % P).to_bytes(32, "little")


_ED_D = -121665 * pow(121666, P - 2, P) % P


def _ed_base():
    y = 4 * pow(5, P - 2, P) % P
    x2 = (y * y - 1) * pow(_ED_D * y * y + 1, P - 2, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * pow(2, (P - 1) // 4, P) % P
    return (P - x if x & 1 else x, y)


_ED_BASE = _ed_base()


def _ed_add(p, q):
    """Affine Edwards addition (complete formulas), two inversions."""
    (x1, y1), (x2, y2) = p, q
    k = _ED_D * x1 * x2 * y1 * y2 % P
    return ((x1 * y2 + x2 * y1) * pow(1 + k, P - 2, P) % P,
            (y1 * y2 + x1 * x2) * pow(1 - k, P - 2, P) % P)


def _ed_mult(k, p):
    r = (0, 1)
    while k:
        if k & 1:
            r = _ed_add(r, p)
        p = _ed_add(p, p)
        k >>= 1
    return r


def _ed_enc(p):
    x, y = p
    return (y | (x & 1) << 255).to_bytes(32, "little")


def _ed_base_enc(k):
    return _ed_enc(_ed_mult(k, _ED_BASE))


def _ed_decompress(b):
    """RFC 8032 5.1.3 decoding with the reference's leniency: y >= p is
    taken mod p and x = 0 takes either sign; None off the curve."""
    v = int.from_bytes(b, "little")
    y = (v & ((1 << 255) - 1)) % P
    x2 = (y * y - 1) * pow(_ED_D * y * y + 1, P - 2, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P:
        return None
    return ((P - x) % P if (x & 1) != v >> 255 else x, y)


def _clamp_int(b):
    b = bytearray(b)
    b[0] &= 248
    b[31] = (b[31] & 127) | 64
    return int.from_bytes(b, "little")


def oracle_ed25519_pk(seed: bytes) -> bytes:
    """RFC 8032 5.1.5 public key on Python integers and hashlib."""
    return _ed_base_enc(_clamp_int(hashlib.sha512(seed).digest()[:32]))


def oracle_ed25519_sign(seed: bytes, pk: bytes, msg: bytes) -> bytes:
    """RFC 8032 5.1.6 signature on Python integers and hashlib."""
    md = hashlib.sha512(seed).digest()
    a = _clamp_int(md[:32])
    r = int.from_bytes(hashlib.sha512(md[32:] + msg).digest(), "little") % ELL
    R = _ed_base_enc(r)
    h = int.from_bytes(hashlib.sha512(R + pk + msg).digest(), "little") % ELL
    return R + ((r + h * a) % ELL).to_bytes(32, "little")


def _h_int(r, pk, msg):
    return int.from_bytes(hashlib.sha512(r + pk + msg).digest(), "little") % ELL


def oracle_ed25519_verify(sig, pk, msg, strict=False):
    """Ed25519 verification on Python integers with the JAX package's
    semantics: enc(s*G - h*Q) == R as bytes; S >= l only under strict."""
    q = _ed_decompress(pk)
    s = int.from_bytes(sig[32:], "little")
    if q is None or (strict and s >= ELL):
        return False
    neg_q = ((P - q[0]) % P, q[1])
    r = _ed_add(_ed_mult(s, _ED_BASE), _ed_mult(_h_int(sig[:32], pk, msg),
                                                neg_q))
    return _ed_enc(r) == sig[:32]


EDGE_MSG = b"edge vector msg!"


def edge_vectors():
    """The 16 vectors of tests/test_edge_encodings.py (name, pk, sig, msg,
    verdict, strict verdict), rebuilt on Python integers."""
    def le(v):
        return v.to_bytes(32, "little")

    seed = b"\x01" * 32
    pk = oracle_ed25519_pk(seed)
    sig = oracle_ed25519_sign(seed, pk, EDGE_MSG)
    s_int = int.from_bytes(sig[32:], "little")
    a = _clamp_int(hashlib.sha512(seed).digest()[:32])

    def forge_for(pk_bytes, order):
        for s_try in range(1, 400):
            r = _ed_base_enc(s_try)
            if _h_int(r, pk_bytes, EDGE_MSG) % order == 0:
                return r + le(s_try)
        fail("no forgery scalar found")

    forge_id = _ed_base_enc(12345) + le(12345)
    r_id, r_nc = le(1), le(P + 1)        # enc(identity), and non-canonical
    sig_r0 = r_id + le(_h_int(r_id, pk, EDGE_MSG) * a % ELL)
    sig_rnc = r_nc + le(_h_int(r_nc, pk, EDGE_MSG) * a % ELL)
    return [
        ("valid", pk, sig, EDGE_MSG, True, True),
        ("tampered-msg", pk, sig, b"edge vector msg?", False, False),
        ("tampered-sig", pk, bytes([sig[0] ^ 1]) + sig[1:], EDGE_MSG, False,
         False),
        ("pk-not-on-curve", le(2), sig, EDGE_MSG, False, False),
        ("pk-max-y", le(2**255 - 1), sig, EDGE_MSG, False, False),
        ("identity-pk-forge", le(1), forge_id, EDGE_MSG, True, True),
        ("identity-pk-noncanonical", le(P + 1), forge_id, EDGE_MSG, True,
         True),
        ("identity-pk-signbit", le(1 | 1 << 255), forge_id, EDGE_MSG, True,
         True),
        ("zero-pk-forge", le(0), forge_for(le(0), 8), EDGE_MSG, True, True),
        ("zero-pk-noncanonical", le(P), forge_for(le(P), 8), EDGE_MSG, True,
         True),
        ("malleable-s-plus-l", pk, sig[:32] + le(s_int + ELL), EDGE_MSG, True,
         False),
        ("malleable-s-plus-2l", pk, sig[:32] + le(s_int + 2 * ELL), EDGE_MSG,
         True, False),
        ("s-all-ff", pk, sig[:32] + b"\xff" * 32, EDGE_MSG, False, False),
        ("s-zero", pk, sig[:32] + bytes(32), EDGE_MSG, False, False),
        ("r-zero-sig", pk, sig_r0, EDGE_MSG, True, True),
        ("noncanonical-R-bytes", pk, sig_rnc, EDGE_MSG, False, False),
    ]


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------
def hex_bytes(s, device):
    return torch.tensor(list(bytes.fromhex(s)), dtype=torch.uint8,
                        device=device)


def row_bytes(t):
    return bytes(t.cpu().tolist())


def rand_bytes(rng, shape, dev):
    return torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)


def max_abs_err(a, b):
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def same(a, b):
    return max_abs_err(a, b) == 0


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def timed_once(fn, *args):
    """(device seconds of one call by CUDA events, its output); the caller
    warms the function up first."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out


class Counts:
    """Every kernel's launch count, set to 0 and read around one path."""

    def __init__(self):
        from curve25519_tpu_torch.ops.cuda import (
            edwards_kernel, ladder_kernel, sha512_kernel, sign_kernel,
            verify_kernel,
        )
        self.mods = {"x25519_ladder_kernel": ladder_kernel,
                     "basemult_kernel": edwards_kernel,
                     "sha512_kernel": sha512_kernel}
        # kernels counted in a module's launches dict: (the dict, its key)
        self.keyed = {"keygen_kernel": (sign_kernel.launches, "keygen"),
                      "sign_kernel": (sign_kernel.launches, "sign")}
        for key in verify_kernel.launches:
            self.keyed[key + "_kernel"] = (verify_kernel.launches, key)
        self.total = {k: 0 for k in KERNELS}

    def zero(self):
        for m in self.mods.values():
            m.launches = 0
        for d, key in self.keyed.values():
            d[key] = 0

    def read(self):
        got = {k: m.launches for k, m in self.mods.items()}
        got.update({k: d[key] for k, (d, key) in self.keyed.items()})
        for k, v in got.items():
            self.total[k] += v
        return got

    def drive(self, fn, *args):
        """Run one main path with the counts zeroed before and read after;
        returns (its output, host wall seconds, the counts)."""
        torch.cuda.synchronize()
        self.zero()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, self.read()


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for the work of one call.
# Per lane the kernels issue int32 multiply-adds (IMAD, on the FMA pipe) for
# the limb products and plain int32 logic, shift and add operations (on the
# ALU pipe) for the SHA-512 rounds. Counted from the algorithm and
# calibrated on the ladder's SASS (a field multiply is 422 IMAD with its
# reduction, a squaring 232, a small-constant multiply 22): each pipe
# issues 64 lanes per clock per SM. A constant-time gather of a table entry
# is counted as what the card needs at least for it: the exact int8 one-hot
# product [lanes x entries] x [entries x 120 bytes] at the tensor cores'
# int8 rate (1,979 TOP/s dense). The carries, moves and loads are not
# counted, so the bound is below the true least time. Bytes: each input
# read once and each output written once at 3.35 TB/s.
# ---------------------------------------------------------------------------
IMAD_MUL, IMAD_SQR, IMAD_SMALL = 422, 232, 22
IMAD_SC_MUL = 400 + 399 + 20 + 10       # products, FOLD_SC, 2^260, delta
IMAD_SC_REDUCE = 399 + 20 + 10           # from_digest's reduce40
SHA_BLOCK_ALU = 80 * 32 + 64 * 22        # 64-bit rounds and schedule
ENTRY_BYTES = 120                        # 60 limbs, a low and a high byte
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def _inv_imad():
    return 254 * IMAD_SQR + 11 * IMAD_MUL


def basemult_ops(nfolds, use_bp=False):
    """(IMAD, ALU, tensor-core int8 operations) per lane of one base
    multiply with its epilogue (any mode: one inversion and two
    multiplies)."""
    steps = 256 // nfolds - 1
    muls = 4 + steps * 11 + (8 if use_bp else 0) + 2
    sqrs = steps * 4
    gathers = steps + 1
    onehot = gathers * 2 * (1 << nfolds) * ENTRY_BYTES   # multiply-adds
    return muls * IMAD_MUL + sqrs * IMAD_SQR + _inv_imad(), 0, onehot


def ladder_ops():
    step = 5 * IMAD_MUL + 4 * IMAD_SQR + IMAD_SMALL
    start = 3 * IMAD_MUL + 2 * IMAD_SQR + IMAD_SMALL
    return 254 * step + start + _inv_imad(), 0, 0


def keygen_ops(use_bl=False):
    imad, alu, onehot = basemult_ops(8, use_bp=use_bl)
    if use_bl:
        imad += 10 + 10                   # the mod and add of a + bl
    return imad, alu + SHA_BLOCK_ALU, onehot


def sign_ops(blocks, use_bl=False):
    """blocks: SHA-512 blocks of the two message hashes (data-dependent)."""
    imad, alu, onehot = basemult_ops(8, use_bp=use_bl)
    imad += 2 * IMAD_SC_REDUCE + IMAD_SC_MUL + 20
    return imad, alu + (1 + blocks) * SHA_BLOCK_ALU, onehot


def verify_init_ops():
    """Decompression (sqrt ratio and x*y: 20 M, 256 S), 192 doublings, 15
    PE conversions and 11 PE adds."""
    muls = 20 + 192 * 4 + 15 + 11 * 8
    sqrs = 256 + 192 * 4
    return muls * IMAD_MUL + sqrs * IMAD_SQR, 0, 0


def poly_ops():
    """63 doublings, 63 PE adds, 32 PA adds (table entries read by index),
    the start's and the epilogue's multiplies and one inversion."""
    muls = 63 * 4 + 63 * 8 + 32 * 7 + 3
    sqrs = 63 * 4
    return muls * IMAD_MUL + sqrs * IMAD_SQR + _inv_imad(), 0, 0


def oneshot_ops():
    return tuple(a + b for a, b in zip(verify_init_ops(), poly_ops()))


def bound_ms(lanes_ops, nbytes):
    """lanes_ops: summed (IMAD, ALU, tensor-core int8 operations) over the
    call's lanes."""
    props = torch.cuda.get_device_properties(0)
    rate = props.multi_processor_count * 64 * max_sm_clock_hz()
    imad, alu, onehot = lanes_ops
    t_ops = max(imad / rate, alu / rate, onehot / INT8_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# Phases 1-5: the card, the build, the X25519 ladder
# ---------------------------------------------------------------------------
def phase_device():
    card = card_line()
    print(card)
    print("phase 1 device: %s | torch %s | CUDA %s | python %s"
          % (torch.cuda.get_device_name(0), torch.__version__,
             torch.version.cuda, sys.version.split()[0]))
    return card


def phase_build():
    from curve25519_tpu_torch.ops.cuda import build
    report = build.build_cuda()
    kernels = {}
    for name in build.LIBRARIES:
        build.load_cuda(name)
        for kernel, info in report[name]["kernels"].items():
            check("registers" in info, "no ptxas report for " + kernel)
            kernels[kernel] = info
            print("phase 2 build: %s.cu %.1f s | %s: %d registers/thread, "
                  "spill stores %d B, spill loads %d B, stack %d B"
                  % (name, report[name]["build_seconds"], kernel,
                     info["registers"], info["spill_store_bytes"],
                     info["spill_load_bytes"], info["stack_bytes"]))
    print("phase 2 build: %d sources in parallel, %.1f s wall"
          % (len(build.LIBRARIES), report["wall_seconds"]))
    return kernels


def phase_ladder_vs_plain(dev, rng, lanes=CHECK_LANES):
    from curve25519_tpu_torch.config import int_to_limbs
    from curve25519_tpu_torch.models import montgomery
    from curve25519_tpu_torch.ops.cuda.ladder_kernel import point_multiply_cuda

    u = rand_bytes(rng, (lanes, 32), dev)
    k = rand_bytes(rng, (lanes, 32), dev)
    got = point_multiply_cuda(u, k)
    want = montgomery.point_multiply(u, k)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, "kernel != plain on %d random lanes" % lanes)

    sk7 = torch.full((len(EDGE_U), 32), 7, dtype=torch.uint8, device=dev)
    peers = torch.tensor([list(v.to_bytes(32, "little")) for v in EDGE_U],
                         dtype=torch.uint8, device=dev)
    edge = point_multiply_cuda(peers, sk7)
    check(torch.equal(edge, montgomery.point_multiply(peers, sk7)),
          "kernel != plain on the edge u values")
    for i, v in enumerate(EDGE_U):
        check(row_bytes(edge[i]) == oracle_x25519(b"\x07" * 32,
                                                  v.to_bytes(32, "little")),
              "edge u=%s disagrees with the oracle" % hex(v))

    zero_peer = point_multiply_cuda(torch.zeros_like(u[:64]), k[:64])
    check(not zero_peer.any(), "all-zero peer gave a nonzero secret")

    zr_vals = [int.from_bytes(rng.bytes(32), "little") % P or 1
               for _ in range(lanes)]
    zr = torch.from_numpy(np.stack([int_to_limbs(v) for v in zr_vals])).to(dev)
    check(torch.equal(point_multiply_cuda(u, k, zr=zr), got),
          "a nonzero zr changed the kernel's output")
    check(torch.equal(montgomery.point_multiply(u[:256], k[:256], zr=zr[:256]),
                      got[:256]), "a nonzero zr changed the plain output")

    for n in (1, 127, 129, 1000):
        check(torch.equal(point_multiply_cuda(u[:n], k[:n]), got[:n]),
              "ragged batch of %d lanes != the full batch's rows" % n)
    check(torch.equal(point_multiply_cuda(u[5], k[5]), got[5]),
          "rank-1 call != its batch row")
    bcast = point_multiply_cuda(u[3], k[:16])
    check(bcast.shape == (16, 32) and torch.equal(
        bcast, montgomery.point_multiply(u[3], k[:16])),
        "broadcast of one point over 16 keys != plain")
    torch.cuda.synchronize()
    print("phase 3 ladder vs plain: %d random lanes, %d edge u, zero peer, "
          "zr, ragged 1/127/129/1000, rank-1, broadcast: byte-equal "
          "(max_abs_err %d)" % (lanes, len(EDGE_U), err))
    return err


def phase_x25519_known_answers(dev, rng):
    from curve25519_tpu_torch.models import x25519

    u = torch.stack([hex_bytes(V1_U, dev), hex_bytes(V2_U, dev)])
    k = torch.stack([hex_bytes(V1_K, dev), hex_bytes(V2_K, dev)])
    out = x25519.create_shared_key(u, k)
    check(row_bytes(out[0]).hex() == V1_OUT, "RFC 7748 5.2 vector 1")
    check(row_bytes(out[1]).hex() == V2_OUT, "RFC 7748 5.2 vector 2")
    sks = torch.stack([hex_bytes(A_SK, dev), hex_bytes(B_SK, dev)])
    pks = x25519.calculate_public_key(sks)
    check(row_bytes(pks[0]).hex() == A_PK, "RFC 7748 6.1 Alice pk")
    check(row_bytes(pks[1]).hex() == B_PK, "RFC 7748 6.1 Bob pk")
    check(torch.equal(x25519.calculate_public_key_fast(sks), pks),
          "RFC 7748 6.1 pk through the fold-8 base multiply")
    shared = x25519.create_shared_key(pks.flip(0), sks)
    check(row_bytes(shared[0]).hex() == SHARED
          and row_bytes(shared[1]).hex() == SHARED, "RFC 7748 6.1 shared")

    sk = rng.integers(0, 256, (ORACLE_LANES, 32), np.uint8)
    peer = rng.integers(0, 256, (ORACLE_LANES, 32), np.uint8)
    got = x25519.create_shared_key(torch.from_numpy(peer).to(dev),
                                   torch.from_numpy(sk).to(dev))
    for i in range(ORACLE_LANES):
        check(row_bytes(got[i]) == oracle_x25519(sk[i].tobytes(),
                                                 peer[i].tobytes()),
              "lane %d disagrees with the Python oracle" % i)
    print("phase 4 X25519 known answers: RFC 7748 5.2 (2), 6.1 (pk, pk, "
          "fast pk, shared), %d random lanes vs the Python-integer oracle: ok"
          % ORACLE_LANES)


def phase_x25519_main(dev, rng, card, counts, batch=MAIN_BATCH):
    from curve25519_tpu_torch.models import montgomery, x25519
    from curve25519_tpu_torch.utils.profiling import bench

    sk_a = rand_bytes(rng, (batch, 32), dev)
    sk_b = rand_bytes(rng, (batch, 32), dev)

    def exchange():
        pk_a = x25519.calculate_public_key(sk_a)
        pk_b = x25519.calculate_public_key(sk_b)
        return (pk_b, x25519.create_shared_key(pk_b, sk_a),
                x25519.create_shared_key(pk_a, sk_b))

    (pk_b, s_ab, s_ba), wall, got = counts.drive(exchange)
    launches = got["x25519_ladder_kernel"]
    check(launches > 0, "the main path launched the ladder kernel 0 times")
    check(s_ab.shape == (batch, 32) and s_ab.dtype == torch.uint8,
          "shared secret has shape %s %s" % (tuple(s_ab.shape), s_ab.dtype))
    check(torch.equal(s_ab, s_ba), "shared secrets differ on %d of %d lanes"
          % (int((s_ab != s_ba).any(-1).sum()), batch))
    for i in range(ORACLE_LANES):
        check(row_bytes(s_ab[i]) == oracle_x25519(
            row_bytes(sk_a[i]), row_bytes(pk_b[i])),
            "main-path lane %d disagrees with the Python oracle" % i)
    print("phase 5 X25519 main path: %d lanes, 2 x calculate_public_key + 2 x "
          "create_shared_key in %.3f s wall, %d kernel launches, secrets "
          "agree on every lane" % (batch, wall, launches))

    kernel_s = bench(x25519.create_shared_key, pk_b, sk_a, reps=3, rounds=3)
    montgomery.point_multiply(pk_b[:8], sk_a[:8])   # warm the plain path
    plain_s, plain = timed_once(montgomery.point_multiply, pk_b, sk_a)
    err = max_abs_err(plain, s_ab)
    check(err == 0, "plain != kernel at the main batch")
    bms, by = bound_ms(tuple(batch * v for v in ladder_ops()), batch * 96)
    print("phase 5 timing [%s]: create_shared_key B=%d kernel %.3f ms "
          "(%.1f ops/s, best of 3 x 3 after warm-up) | plain PyTorch %.3f ms "
          "(%.1f ops/s, one call) | bound %.3f ms (%s) | byte-equal"
          % (card, batch, kernel_s * 1e3, batch / kernel_s, plain_s * 1e3,
             batch / plain_s, bms, by))
    return {"max_abs_err": err, "ms": kernel_s * 1e3,
            "plain_ms": plain_s * 1e3, "bound_ms": bms, "bound_by": by}


# ---------------------------------------------------------------------------
# Phases 6-8: base multiply, SHA-512, keygen, sign
# ---------------------------------------------------------------------------
def phase_ed_kernels_vs_plain(dev, rng, lanes=CHECK_LANES):
    from curve25519_tpu_torch.models import blinding
    from curve25519_tpu_torch.ops import fold, sha512
    from curve25519_tpu_torch.ops.cuda import edwards_kernel as ek
    from curve25519_tpu_torch.ops.cuda import sign_kernel as sgk

    errs = {k: 0 for k in ("basemult_kernel", "sha512_kernel",
                           "keygen_kernel", "sign_kernel")}

    def hold(name, got, want, what):
        err = max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        check(err == 0, "%s != plain: %s" % (name, what))

    ctx = blinding.blinding_init(b"chip-smoke", device=dev)
    zr = blinding.default_zr(device=dev)
    sk = rand_bytes(rng, (lanes, 32), dev)

    # B3: both folds, every mode, with and without the PE blinding add; the
    # fold-8 kernel's warp-wide gather on partial warps and blocks (ragged
    # sizes) in every mode, plain and blinded, against the plain version's
    # rows; rank-1 and broadcast calls on fold 8 pk
    for nfolds in (8, 4):
        cut = (fold.cut8_bytes if nfolds == 8 else fold.cut4_bytes)(sk)
        for mode in ek.MODES:
            for bp in (None, ctx["bp"]):
                what = "fold %d %s bp=%s" % (nfolds, mode, bp is not None)
                want = ek.base_mult_plain(cut, zr=ctx["zr"], bp=bp, mode=mode,
                                          nfolds=nfolds)
                hold("basemult_kernel",
                     ek.base_mult(cut, zr=ctx["zr"], bp=bp, mode=mode,
                                  nfolds=nfolds), want, what)
                for n in RAGGED if nfolds == 8 else ():
                    hold("basemult_kernel",
                         ek.base_mult(cut[:n], zr=ctx["zr"], bp=bp, mode=mode),
                         tuple(w[:n] for w in want) if isinstance(want, tuple)
                         else want[:n], "%s, ragged %d" % (what, n))
    cut = fold.cut8_bytes(sk)
    full = ek.base_mult(cut, zr=zr, mode="pk")
    hold("basemult_kernel", ek.base_mult(cut[5], zr=zr, mode="pk"), full[5],
         "rank-1")
    hold("basemult_kernel", ek.base_mult(cut[:16], zr=ctx["zr"][None, :],
                                         mode="pk"), full[:16], "broadcast zr")

    # B4: the padding edges, a prefix, ragged and rank-1 calls
    msg = rand_bytes(rng, (lanes, 240), dev)
    lengths = torch.from_numpy(rng.integers(0, 241, lanes).astype(np.int32))
    lengths[:len(SHA_LENGTHS)] = torch.tensor(SHA_LENGTHS)
    lengths = lengths.to(dev)
    prefix = rand_bytes(rng, (lanes, 32), dev)
    for pre in (None, prefix):
        got = sha512.sha512(msg, lengths, prefix=pre)
        hold("sha512_kernel", got, sha512.sha512_plain(msg, lengths, prefix=pre),
             "random lengths, prefix=%s" % (pre is not None))
        for n in RAGGED:
            hold("sha512_kernel", sha512.sha512(
                msg[:n], lengths[:n], prefix=None if pre is None else pre[:n]),
                got[:n], "ragged %d" % n)
    hold("sha512_kernel", sha512.sha512(msg[7, :int(lengths[7])]),
         sha512.sha512_plain(msg[7:8], lengths[7:8])[0], "rank-1")
    hold("sha512_kernel", sha512.sha512(msg[:64], lengths[:64],
                                        prefix=prefix[0]),
         sha512.sha512_plain(msg[:64], lengths[:64], prefix=prefix[0]),
         "one prefix broadcast over 64 messages")

    # B6: plain and blinded keygen; the warp-wide tensor-core gather on
    # partial warps and blocks (ragged, plain and blinded), rank-1
    pk = sgk.keygen(sk, zr=zr)
    hold("keygen_kernel", pk, sgk.keygen_plain(sk, zr=zr), "random lanes")
    hold("keygen_kernel", sgk.keygen(sk, zr=ctx["zr"], bl=ctx["bl"],
                                     bp=ctx["bp"]), pk, "blinded")
    for n in RAGGED:
        hold("keygen_kernel", sgk.keygen(sk[:n], zr=zr), pk[:n],
             "ragged %d" % n)
        hold("keygen_kernel", sgk.keygen(sk[:n], zr=ctx["zr"], bl=ctx["bl"],
                                         bp=ctx["bp"]), pk[:n],
             "ragged %d, blinded" % n)
    hold("keygen_kernel", sgk.keygen(sk[9], zr=zr), pk[9], "rank-1")

    # B7: random lengths up to 64 bytes, the fused cap (943), blinded,
    # ragged, rank-1 and one key broadcast over many messages
    priv = torch.cat([sk, pk], -1)
    msg = rand_bytes(rng, (lanes, 943), dev)
    for L in (64, 943):
        ml = torch.from_numpy(rng.integers(0, L + 1, lanes).astype(np.int32))
        ml[0], ml[1] = 0, L
        ml = ml.to(dev)
        m = msg[:, :L]
        sig = sgk.sign_fused(priv, m, ml, zr=zr)
        hold("sign_kernel", sig, sgk.sign_plain(priv, m, ml, zr=zr),
             "%d-byte messages" % L)
        hold("sign_kernel", sgk.sign_fused(priv, m, ml, zr=ctx["zr"],
                                           bl=ctx["bl"], bp=ctx["bp"]), sig,
             "%d-byte messages, blinded" % L)
        for n in RAGGED:
            hold("sign_kernel", sgk.sign_fused(priv[:n], m[:n], ml[:n], zr=zr),
                 sig[:n], "ragged %d" % n)
            hold("sign_kernel", sgk.sign_fused(
                priv[:n], m[:n], ml[:n], zr=ctx["zr"], bl=ctx["bl"],
                bp=ctx["bp"]), sig[:n], "ragged %d, blinded" % n)
    hold("sign_kernel", sgk.sign_fused(priv[3], m[3], ml[3], zr=zr), sig[3],
         "rank-1")
    hold("sign_kernel", sgk.sign_fused(priv[0], m[:16], ml[:16], zr=zr),
         sgk.sign_plain(priv[0], m[:16], ml[:16], zr=zr), "broadcast key")
    check(sgk.max_fused_msg_len(943) and not sgk.max_fused_msg_len(944),
          "the fused cap is not at 943/944 bytes")
    # 944 bytes: one past the cap, the composition of the SHA-512 and
    # base-multiply kernels
    m944 = rand_bytes(rng, (256, 944), dev)
    n944 = torch.full((256,), 944, dtype=torch.int32, device=dev)
    hold("sign_kernel", sgk.sign_composed(priv[:256], m944, n944, zr=zr),
         sgk.sign_plain(priv[:256], m944, n944, zr=zr), "944-byte messages")
    torch.cuda.synchronize()
    print("phase 6 kernels vs plain: %d random lanes; base multiply fold 8 "
          "and 4 x 4 modes x (no BP, BP), fold 8 also ragged in each; "
          "SHA-512 random lengths and "
          "padding edges, prefix; keygen and sign (64 and 943 bytes fused, "
          "944 composed) plain and blinded with "
          "blinding_init(b'chip-smoke'), each also ragged; ragged %s, "
          "rank-1, broadcast: "
          "byte-equal (max_abs_err %s)"
          % (lanes, "/".join(map(str, RAGGED)), errs))
    return errs


def phase_ed_known_answers(dev, rng):
    from curve25519_tpu_torch.models import ed25519
    from curve25519_tpu_torch.ops import sha512

    sks = torch.stack([hex_bytes(v[0], dev) for v in ED_VECS])
    pk, priv = ed25519.create_keypair(sks)
    for i, v in enumerate(ED_VECS):
        check(row_bytes(pk[i]).hex() == v[1], "RFC 8032 TEST %d pk" % (i + 1))
    msg = torch.zeros((3, 8), dtype=torch.uint8, device=dev)
    lengths = []
    for i, v in enumerate(ED_VECS):
        b = bytes.fromhex(v[2])
        msg[i, :len(b)] = torch.tensor(list(b), dtype=torch.uint8)
        lengths.append(len(b))
    sig = ed25519.sign(priv, msg, torch.tensor(lengths, dtype=torch.int32,
                                               device=dev))
    for i, v in enumerate(ED_VECS):
        check(row_bytes(sig[i]).hex() == v[3], "RFC 8032 TEST %d sig" % (i + 1))

    data = rng.integers(0, 256, (len(SHA_LENGTHS), 240), np.uint8)
    got = sha512.sha512(torch.from_numpy(data).to(dev),
                        torch.tensor(SHA_LENGTHS, dtype=torch.int32,
                                     device=dev))
    for i, n in enumerate(SHA_LENGTHS):
        check(row_bytes(got[i]) == hashlib.sha512(data[i, :n].tobytes())
              .digest(), "SHA-512 of %d bytes != hashlib" % n)

    seeds = rng.integers(0, 256, (ORACLE_LANES, 32), np.uint8)
    pk, priv = ed25519.create_keypair(torch.from_numpy(seeds).to(dev))
    for L in (64, 3000):
        m = rng.integers(0, 256, (ORACLE_LANES, L), np.uint8)
        n = rng.integers(0, L + 1, ORACLE_LANES).astype(np.int32)
        n[0] = L
        sig = ed25519.sign(priv, torch.from_numpy(m).to(dev),
                           torch.from_numpy(n).to(dev))
        for i in range(ORACLE_LANES):
            check(row_bytes(pk[i]) == oracle_ed25519_pk(seeds[i].tobytes()),
                  "pk lane %d disagrees with the Python oracle" % i)
            check(row_bytes(sig[i]) == oracle_ed25519_sign(
                seeds[i].tobytes(), row_bytes(pk[i]), m[i, :n[i]].tobytes()),
                "%d-byte sign lane %d disagrees with the Python oracle"
                % (L, i))
    print("phase 7 Ed25519 known answers: RFC 8032 TEST 1-3 (pk, sig), "
          "SHA-512 of %s bytes vs hashlib, %d random lanes (64- and up to "
          "3,000-byte messages) vs the Python-integer Ed25519: ok"
          % ("/".join(map(str, SHA_LENGTHS)), ORACLE_LANES))


def phase_ed_main(dev, rng, card, counts, batch=MAIN_BATCH):
    from curve25519_tpu_torch.models import blinding, ed25519, x25519
    from curve25519_tpu_torch.ops import fold, sha512
    from curve25519_tpu_torch.ops.cuda import (
        edwards_kernel as ek, sha512_kernel as shk, sign_kernel as sgk,
    )

    seeds = rand_bytes(rng, (batch, 32), dev)
    msg = rand_bytes(rng, (batch, 64), dev)
    ctx = blinding.blinding_init(b"chip-smoke", device=dev)
    lines = []

    # keygen
    (pk, priv), wall, got = counts.drive(ed25519.create_keypair, seeds)
    check(got["keygen_kernel"] == 1, "keygen launched %s" % got)
    for i in (0, batch // 2, batch - 1):
        check(row_bytes(pk[i]) == oracle_ed25519_pk(row_bytes(seeds[i])),
              "main-path pk lane %d disagrees with the Python oracle" % i)
    lines.append("create_keypair %.3f s (%s)" % (wall, got["keygen_kernel"]))

    # sign, plain and blinded
    sig, wall, got = counts.drive(ed25519.sign, priv, msg)
    check(got["sign_kernel"] == 1, "sign launched %s" % got)
    for i in (0, batch - 1):
        check(row_bytes(sig[i]) == oracle_ed25519_sign(
            row_bytes(seeds[i]), row_bytes(pk[i]), row_bytes(msg[i])),
            "main-path signature lane %d disagrees with the Python oracle" % i)
    lines.append("sign %.3f s (%d)" % (wall, got["sign_kernel"]))
    sig_bl, wall, got = counts.drive(
        lambda: ed25519.sign(priv, msg, blinding=ctx))
    check(got["sign_kernel"] == 1 and torch.equal(sig_bl, sig),
          "the blinded sign changed a signature or did not launch")
    lines.append("blinded sign %.3f s (%d)" % (wall, got["sign_kernel"]))

    # the fold-8 and fold-4 X25519 public key against the ladder, all lanes
    ladder_pk = x25519.calculate_public_key(seeds)
    for nfolds in (8, 4):
        fast, wall, got = counts.drive(
            lambda: x25519.calculate_public_key_fast(seeds, nfolds=nfolds))
        check(got["basemult_kernel"] == 1, "fast pk launched %s" % got)
        check(torch.equal(fast, ladder_pk), "fold-%d public key != ladder on "
              "%d of %d lanes" % (nfolds, int((fast != ladder_pk).any(-1)
                                              .sum()), batch))
        lines.append("calculate_public_key_fast(nfolds=%d) %.3f s (%d), "
                     "== ladder on all lanes" % (nfolds, wall,
                                                 got["basemult_kernel"]))

    # sha512 of the 64-byte messages
    digest, wall, got = counts.drive(sha512.sha512, msg)
    check(got["sha512_kernel"] == 1, "sha512 launched %s" % got)
    for i in (0, batch - 1):
        check(row_bytes(digest[i]) == hashlib.sha512(row_bytes(msg[i]))
              .digest(), "main-path digest lane %d != hashlib" % i)
    lines.append("sha512 %.3f s (%d)" % (wall, got["sha512_kernel"]))

    # the long-message sign: SHA-512 of several blocks per lane, each lane
    # its own count, through the SHA-512 and base-multiply kernels
    long = rand_bytes(rng, (LONG_LANES, 4096), dev)
    n_long = torch.from_numpy(rng.integers(944, 4097, LONG_LANES)
                              .astype(np.int32)).to(dev)
    sig_long, wall, got = counts.drive(ed25519.sign, priv[:LONG_LANES], long,
                                       n_long)
    check(got["sha512_kernel"] == 3 and got["basemult_kernel"] == 1
          and got["sign_kernel"] == 0, "long sign launched %s" % got)
    check(torch.equal(sig_long, sgk.sign_plain(
        priv[:LONG_LANES], long, n_long, zr=blinding.default_zr(device=dev))),
        "long-message sign != plain")
    for i in (0, LONG_LANES - 1):
        check(row_bytes(sig_long[i]) == oracle_ed25519_sign(
            row_bytes(seeds[i]), row_bytes(pk[i]),
            row_bytes(long[i, :int(n_long[i])])),
            "long-message lane %d disagrees with the Python oracle" % i)
    lines.append("long sign %d lanes of 944-4,096 bytes %.3f s (sha512 %d, "
                 "basemult %d)" % (LONG_LANES, wall, got["sha512_kernel"],
                                   got["basemult_kernel"]))
    print("phase 8 Ed25519 main paths, B = %d (launches): %s"
          % (batch, "; ".join(lines)))

    # timing: each kernel's wrapper on the inputs of the path, best of 3 x 3
    # after a warm-up, against one call of its plain version
    zr = blinding.default_zr(device=dev)
    cut8, cut4 = fold.cut8_bytes(seeds), fold.cut4_bytes(seeds)
    words, nblocks, _ = sha512.pack_words(
        msg, torch.full((batch,), 64, dtype=torch.int32, device=dev))
    ml = torch.full((batch,), 64, dtype=torch.int32, device=dev)
    w3_blocks = sha512.nblocks_static(64 + 32) + sha512.nblocks_static(64 + 64)
    cases = {
        "basemult_kernel": (
            lambda c: ek.base_mult(c, mode="u_bytes"),
            lambda c: ek.base_mult_plain(c, mode="u_bytes"), (cut8,),
            basemult_ops(8), batch * (128 + 32)),
        "basemult_fold4": (
            lambda c: ek.base_mult(c, mode="u_bytes", nfolds=4),
            lambda c: ek.base_mult_plain(c, mode="u_bytes", nfolds=4), (cut4,),
            basemult_ops(4), batch * (256 + 32)),
        "sha512_kernel": (shk.sha512_blocks, shk.sha512_blocks_plain,
                          (words, nblocks), (0, SHA_BLOCK_ALU, 0),
                          batch * (128 + 4 + 64)),
        "keygen_kernel": (
            lambda s: sgk.keygen(s, zr=zr),
            lambda s: sgk.keygen_plain(s, zr=zr), (seeds,), keygen_ops(),
            batch * (32 + 32)),
        "sign_kernel": (
            lambda p, m, n: sgk.sign_fused(p, m, n, zr=zr),
            lambda p, m, n: sgk.sign_plain(p, m, n, zr=zr), (priv, msg, ml),
            sign_ops(w3_blocks), batch * (64 + 64 + 4 + 64)),
    }
    rows = time_kernels(cases, batch, card, 8)
    time_long_sha512(dev, card)
    for label, fn, args in (
            ("create_keypair", ed25519.create_keypair, (seeds,)),
            ("sign", ed25519.sign, (priv, msg)),
            ("calculate_public_key_fast", x25519.calculate_public_key_fast,
             (seeds,)),
            ("sha512", sha512.sha512, (msg,))):
        print("phase 8 profile [%s]: %s B=%d, 3 calls: %s"
              % (card, label, batch, profile(fn, *args)))
    return rows


def time_long_sha512(dev, card, lanes=LONG_SHA_LANES, length=1 << 20):
    """The long-message SHA-512 row in the reference's shape
    (benchmarks/bench_suite.py, sha512_long): 1,024 lanes of 1 MiB with
    lengths 0, 1, 111, L - 1, random and L, made on the card. The kernel on
    the packed words is held against hashlib on a few lanes (the plain
    version is too slow at this size) and timed; the rate counts hashed
    bytes, the bound the active blocks."""
    from curve25519_tpu_torch.ops import sha512
    from curve25519_tpu_torch.ops.cuda import sha512_kernel as shk
    from curve25519_tpu_torch.utils.profiling import bench

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    msg = torch.randint(0, 256, (lanes, length), generator=gen, device=dev,
                        dtype=torch.uint8)
    lengths = torch.cat([
        torch.tensor([0, 1, 111, length - 1], device=dev),
        torch.randint(0, length + 1, (lanes - 5,), generator=gen, device=dev),
        torch.tensor([length], device=dev)]).to(torch.int32)
    pack_s, (words, nblocks, _) = timed_once(sha512.pack_words, msg, lengths)
    digest = shk.sha512_blocks(words, nblocks)
    for i in (0, 1, 2, 3, 4, lanes - 1):
        check(row_bytes(digest[i]) == hashlib.sha512(
            msg[i, :int(lengths[i])].cpu().numpy().tobytes()).digest(),
            "long SHA-512 lane %d (%d bytes) != hashlib"
            % (i, int(lengths[i])))
    kernel_s = bench(shk.sha512_blocks, words, nblocks, reps=2, rounds=3)
    hashed = int(lengths.to(torch.int64).sum())
    active = int(nblocks.to(torch.int64).sum())
    bms, by = bound_ms((0, active * SHA_BLOCK_ALU, 0),
                       active * 128 + lanes * (4 + 64))
    print("phase 8 timing [%s]: sha512_kernel long messages, %d lanes of "
          "%d bytes (lengths 0, 1, 111, L-1, random, L; %d bytes hashed, %d "
          "blocks): kernel %.3f ms (best of 3 x 2 after warm-up), %.2f GB/s "
          "of hashed bytes | pack_words %.3f ms (one call) | bound %.3f ms "
          "(%s), %.1f%% | == hashlib on 6 lanes"
          % (card, lanes, length, hashed, active, kernel_s * 1e3,
             hashed / kernel_s / 1e9, pack_s * 1e3, bms, by,
             100 * bms / (kernel_s * 1e3)))


def time_kernels(cases, batch, card, phase):
    """Per case name: (kernel wrapper, plain version, args, (IMAD, ALU,
    tensor-core int8 operations) per lane, bytes[, args of the plain version's warm-up call, default the
    first 8 rows]). Times the wrapper (best of 3 x 3 after a warm-up) and
    one call of the plain version on the same args, holds the two equal and
    returns each kernel's row for the JSON line."""
    from curve25519_tpu_torch.utils.profiling import bench
    rows = {}
    for name, case in cases.items():
        kernel_fn, plain_fn, args, ops, nbytes = case[:5]
        kernel_s = bench(kernel_fn, *args, reps=3, rounds=3)
        plain_fn(*(case[5] if len(case) > 5 else (a[:8] for a in args)))
        plain_s, plain = timed_once(plain_fn, *args)
        err = max_abs_err(kernel_fn(*args), plain)
        check(err == 0, "%s != plain at the main batch" % name)
        bms, by = bound_ms(tuple(batch * v for v in ops), nbytes)
        rows[name] = {"max_abs_err": err, "ms": kernel_s * 1e3,
                      "plain_ms": plain_s * 1e3, "bound_ms": bms,
                      "bound_by": by}
        print("phase %d timing [%s]: %s B=%d kernel %.3f ms (best of 3 x 3 "
              "after warm-up) | plain PyTorch %.3f ms (one call) | bound "
              "%.3f ms (%s) | byte-equal"
              % (phase, card, name, batch, kernel_s * 1e3, plain_s * 1e3, bms,
                 by))
    return rows


# ---------------------------------------------------------------------------
# Phases 9-11: verify
# ---------------------------------------------------------------------------
# keys that decode specially: y = 0, 1, p, p + 1 (small order, non-canonical)
# with and without the sign bit; y = 2 and 2^255 - 1 (off the curve)
EDGE_PK = [0, 1, 2, P, P + 1, 2**255 - 1, 1 | 1 << 255, P | 1 << 255]


def le_rows(values, dev):
    return torch.tensor([list(v.to_bytes(32, "little")) for v in values],
                        dtype=torch.uint8, device=dev)


def verify_digits(sig, pk, msg, msg_len=None):
    """(u, v): the fold digits of S and of h = SHA512(R || pk || m) mod l,
    as models/ed25519 computes them for the kernels."""
    from curve25519_tpu_torch.ops import fold, sc, sha512
    n = sig.shape[0]
    prefix = torch.cat([sig[:, :32], pk.expand(n, 32)], -1)
    h = sc.from_digest(sha512.sha512(msg, msg_len, prefix=prefix))
    return fold.cut8_bytes(sig[:, 32:]), fold.cut4_limbs(h)


def phase_verify_kernels_vs_plain(dev, rng, lanes=CHECK_LANES):
    from curve25519_tpu_torch.models import ed25519
    from curve25519_tpu_torch.ops import fold, sc
    from curve25519_tpu_torch.ops.cuda import verify_kernel as vk

    errs = {k: 0 for k in ("verify_init_kernel", "poly_kernel",
                           "poly_shared_kernel", "oneshot_kernel")}

    def hold(name, got, want, what):
        err = max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        check(err == 0, "%s != plain: %s" % (name, what))

    # keys: valid ones, random bytes (about half off the curve), edge keys
    pk, _ = ed25519.create_keypair(rand_bytes(rng, (lanes, 32), dev))
    pk[lanes // 2:] = rand_bytes(rng, (lanes - lanes // 2, 32), dev)
    pk[:len(EDGE_PK)] = le_rows(EDGE_PK, dev)
    u = fold.cut8_bytes(rand_bytes(rng, (lanes, 32), dev))
    v = fold.cut4_limbs(sc.from_digest(rand_bytes(rng, (lanes, 64), dev)))

    planes, ok = vk.verify_init(pk)
    hold("verify_init_kernel", (planes, ok), vk.verify_init_plain(pk),
         "%d lanes" % lanes)
    n_ok = int(ok.sum())
    check(lanes // 2 < n_ok < lanes, "keys that decode: %d of %d" % (n_ok,
                                                                     lanes))
    r = vk.poly_mult(u, v, planes)
    hold("poly_kernel", r, vk.poly_mult_plain(u, v, planes),
         "a q_table per lane")
    shared = {}
    for i in (0, 3, 9, lanes - 1):   # y = 0, y = p, a valid key, random
        shared[i] = vk.poly_mult(u, v, planes[i])
        hold("poly_shared_kernel", shared[i],
             vk.poly_mult_plain(u, v, planes[i]), "lane %d's q_table" % i)
    one = vk.verify_oneshot(pk, u, v)
    hold("oneshot_kernel", one, vk.verify_oneshot_plain(pk, u, v),
         "%d lanes" % lanes)
    hold("oneshot_kernel", one, (r, ok), "one-shot != the two phases")
    for n in RAGGED:
        hold("verify_init_kernel", vk.verify_init(pk[:n]),
             (planes[:n], ok[:n]), "ragged %d" % n)
        hold("poly_kernel", vk.poly_mult(u[:n], v[:n], planes[:n]), r[:n],
             "ragged %d" % n)
        hold("poly_shared_kernel", vk.poly_mult(u[:n], v[:n], planes[9]),
             shared[9][:n], "ragged %d" % n)
        hold("oneshot_kernel", vk.verify_oneshot(pk[:n], u[:n], v[:n]),
             (r[:n], ok[:n]), "ragged %d" % n)
    # rank-1 calls (a rank-1 q_table takes the shared kernel), broadcasts
    hold("verify_init_kernel", vk.verify_init(pk[5]), (planes[5], ok[5]),
         "rank-1")
    hold("poly_shared_kernel", vk.poly_mult(u[5], v[5], planes[5]), r[5],
         "rank-1")
    hold("oneshot_kernel", vk.verify_oneshot(pk[5], u[5], v[5]),
         (r[5], ok[5]), "rank-1")
    hold("oneshot_kernel", vk.verify_oneshot(pk[9], u[:16], v[:16]),
         vk.verify_oneshot_plain(pk[9], u[:16], v[:16]), "one key, 16 lanes")
    hold("poly_kernel", vk.poly_mult(u[0], v[:16], planes[:16]),
         vk.poly_mult_plain(u[0], v[:16], planes[:16]), "one s, 16 lanes")

    # the paths on signatures of ragged messages (0-1,200 bytes, up to 11
    # SHA-512 blocks) against the table-free plain oracle
    m = VERIFY_LANES
    pk_m, priv = ed25519.create_keypair(rand_bytes(rng, (m, 32), dev))
    msg = rand_bytes(rng, (m, 1200), dev)
    ml = torch.from_numpy(rng.integers(0, 1201, m).astype(np.int32))
    ml[:4] = torch.tensor([0, 1200, 600, 700], dtype=torch.int32)
    ml = ml.to(dev)
    sig = ed25519.sign(priv, msg, ml)
    sig_one = ed25519.sign(priv[0], msg, ml)           # one key, m messages
    sig[4, 0] ^= 1                                     # R
    sig[5, 40] ^= 1                                    # S
    sig_one[6, 33] ^= 1
    msg[2, 10] ^= 1                                    # the message
    ml_check = ml.clone()
    ml_check[3] -= 1                                   # a shorter message
    want = torch.ones(m, dtype=torch.bool, device=dev)
    want[2:6] = False
    want_one = torch.ones(m, dtype=torch.bool, device=dev)
    want_one[[2, 3, 6]] = False
    ctx_one = ed25519.verify_init(pk_m[0])
    for label, got, expect in (
            ("verify_tablefree", ed25519.verify_tablefree(
                sig, pk_m, msg, ml_check), want),
            ("verify", ed25519.verify(sig, pk_m, msg, ml_check), want),
            ("verify_check", ed25519.verify_check(
                ed25519.verify_init(pk_m), sig, msg, ml_check), want),
            ("shared verify_tablefree", ed25519.verify_tablefree(
                sig_one, pk_m[0], msg, ml_check), want_one),
            ("shared verify_check", ed25519.verify_check(
                ctx_one, sig_one, msg, ml_check), want_one)):
        check(torch.equal(got, expect), "%s on ragged messages: %d of %d "
              "lanes wrong" % (label, int((got != expect).sum()), m))
    torch.cuda.synchronize()
    print("phase 9 verify kernels vs plain: %d lanes (%d keys decode, %d "
          "edge keys), Verify_Init, poly with per-lane and shared q_tables, "
          "one-shot == the two phases, ragged %s, rank-1, broadcast: "
          "byte-equal (max_abs_err %s); verify, verify_check (per-lane, "
          "shared) == the table-free oracle on %d signatures of "
          "0-1,200-byte messages, valid and tampered"
          % (lanes, n_ok, len(EDGE_PK), "/".join(map(str, RAGGED)), errs, m))
    return errs


def phase_verify_known_answers(dev, rng):
    from curve25519_tpu_torch.models import ed25519

    pk = torch.stack([hex_bytes(v[1], dev) for v in ED_VECS])
    sig = torch.stack([hex_bytes(v[3], dev) for v in ED_VECS])
    msg = torch.zeros((3, 8), dtype=torch.uint8, device=dev)
    for i, v in enumerate(ED_VECS):
        b = bytes.fromhex(v[2])
        msg[i, :len(b)] = torch.tensor(list(b), dtype=torch.uint8)
    ml = torch.tensor([len(bytes.fromhex(v[2])) for v in ED_VECS],
                      dtype=torch.int32, device=dev)
    ctx = ed25519.verify_init(pk)
    for tamper in (None, "R", "S", "msg"):
        s, n = sig.clone(), ml + (tamper == "msg")
        if tamper:
            s[:, 1 if tamper == "R" else 40] ^= int(tamper != "msg")
        want = [tamper is None] * 3
        got = [ed25519.verify(s, pk, msg, n).tolist(),
               ed25519.verify_check(ctx, s, msg, n).tolist(),
               [bool(ed25519.verify_check(ed25519.verify_init(pk[i]), s[i],
                                          msg[i], n[i])) for i in range(3)]]
        check(got == [want] * 3, "RFC 8032 TEST 1-3 tampered %s: verify, "
              "verify_check, shared verify_check gave %s" % (tamper, got))

    vecs = edge_vectors()
    pks = torch.stack([torch.tensor(list(v[1]), dtype=torch.uint8)
                       for v in vecs]).to(dev)
    sigs = torch.stack([torch.tensor(list(v[2]), dtype=torch.uint8)
                        for v in vecs]).to(dev)
    msgs = torch.stack([torch.tensor(list(v[3]), dtype=torch.uint8)
                        for v in vecs]).to(dev)
    ctx = ed25519.verify_init(pks)
    for strict in (False, True):
        want = [v[5 if strict else 4] for v in vecs]
        oracle = [oracle_ed25519_verify(v[2], v[1], v[3], strict)
                  for v in vecs]
        check(oracle == want, "the Python-integer verify disagrees with the "
              "frozen edge verdicts (strict=%s)" % strict)
        for label, got in (
                ("verify", ed25519.verify(sigs, pks, msgs, strict=strict)),
                ("verify_check", ed25519.verify_check(ctx, sigs, msgs,
                                                      strict=strict)),
                ("verify_tablefree", ed25519.verify_tablefree(
                    sigs, pks, msgs, strict=strict))):
            bad = [v[0] for v, g, w in zip(vecs, got.tolist(), want)
                   if g != w]
            check(not bad, "%s strict=%s: edge vectors %s" % (label, strict,
                                                             bad))

    seeds = rng.integers(0, 256, (ORACLE_LANES, 32), np.uint8)
    pk, priv = ed25519.create_keypair(torch.from_numpy(seeds).to(dev))
    msg = rand_bytes(rng, (ORACLE_LANES, 64), dev)
    sig = ed25519.sign(priv, msg)
    sig[1, 2] ^= 1
    sig[2, 50] ^= 1
    got = ed25519.verify(sig, pk, msg).tolist()
    for i in range(ORACLE_LANES):
        check(got[i] == oracle_ed25519_verify(
            row_bytes(sig[i]), row_bytes(pk[i]), row_bytes(msg[i])),
            "verify lane %d disagrees with the Python-integer verify" % i)
    print("phase 10 verify known answers: RFC 8032 TEST 1-3 verify and "
          "their tampered R, S and messages do not (verify, verify_check, "
          "shared verify_check); the 16 edge vectors of "
          "tests/test_edge_encodings.py (strict and not) through verify, "
          "verify_check, verify_tablefree and the Python-integer verify; "
          "%d random lanes vs the Python-integer verify: ok" % ORACLE_LANES)


def phase_verify_main(dev, rng, card, counts, batch=MAIN_BATCH):
    from curve25519_tpu_torch.models import ed25519
    from curve25519_tpu_torch.ops.cuda import verify_kernel as vk

    pk, priv = ed25519.create_keypair(rand_bytes(rng, (batch, 32), dev))
    msg = rand_bytes(rng, (batch, 64), dev)
    sig = ed25519.sign(priv, msg)
    sig_one = ed25519.sign(priv[0], msg)          # one key, every message
    bad = [1, batch // 2, batch - 1]
    sig[1, 0] ^= 1                                # R
    sig[batch // 2, 40] ^= 1                      # S
    sig[batch - 1] = sig[0]                       # another message's
    sig_one[bad[0], 63] ^= 1
    sig_one[bad[1], 31] ^= 1
    sig_one[bad[2]] = sig_one[0]
    want = torch.ones(batch, dtype=torch.bool, device=dev)
    want[bad] = False
    ctx_one = ed25519.verify_init(pk[0])
    lines = []

    def path(label, launched, fn, *args):
        out, wall, got = counts.drive(fn, *args)
        others = {k: v for k, v in got.items() if k not in launched}
        check(all(got[k] == n for k, n in launched.items())
              and not any(others.values()), "%s launched %s" % (label, got))
        lines.append("%s %.3f s (%s)" % (label, wall, ", ".join(
            "%s %d" % (k, got[k]) for k in launched)))
        return out

    ctx = path("verify_init", {"verify_init_kernel": 1}, ed25519.verify_init,
               pk)
    check(bool(ctx["ok"].all()), "a valid key did not decode")
    for label, launched, fn, args, expect in (
            ("verify_check", {"sha512_kernel": 1, "poly_kernel": 1},
             ed25519.verify_check, (ctx, sig, msg), want),
            ("verify_check shared", {"sha512_kernel": 1,
                                     "poly_shared_kernel": 1},
             ed25519.verify_check, (ctx_one, sig_one, msg), want),
            ("verify", {"sha512_kernel": 1, "oneshot_kernel": 1},
             ed25519.verify, (sig, pk, msg), want)):
        got = path(label, launched, fn, *args)
        check(torch.equal(got, expect), "%s: %d of %d lanes wrong"
              % (label, int((got != expect).sum()), batch))
    print("phase 11 verify paths, B = %d distinct keys (launches): %s; every "
          "valid lane verifies, the %d tampered lanes do not"
          % (batch, "; ".join(lines), len(bad)))

    u, v = verify_digits(sig, pk, msg)
    u1, v1 = verify_digits(sig_one, pk[0], msg)
    planes1 = ctx_one["planes"]
    cases = {
        "verify_init_kernel": (vk.verify_init, vk.verify_init_plain, (pk,),
                               verify_init_ops(), batch * (32 + 2560 + 1)),
        "poly_kernel": (vk.poly_mult, vk.poly_mult_plain,
                        (u, v, ctx["planes"]), poly_ops(),
                        batch * (128 + 256 + 2560 + 32)),
        "poly_shared_kernel": (vk.poly_mult, vk.poly_mult_plain,
                               (u1, v1, planes1), poly_ops(),
                               batch * (128 + 256 + 32) + 2560,
                               (u1[:8], v1[:8], planes1)),
        "oneshot_kernel": (vk.verify_oneshot, vk.verify_oneshot_plain,
                           (pk, u, v), oneshot_ops(),
                           batch * (32 + 128 + 256 + 32 + 1)),
    }
    rows = time_kernels(cases, batch, card, 11)
    for label, fn, args in (
            ("verify_init", ed25519.verify_init, (pk,)),
            ("verify_check", ed25519.verify_check, (ctx, sig, msg)),
            ("verify_check shared", ed25519.verify_check,
             (ctx_one, sig_one, msg)),
            ("verify", ed25519.verify, (sig, pk, msg))):
        print("phase 11 profile [%s]: %s B=%d, 3 calls: %s"
              % (card, label, batch, profile(fn, *args)))
    return rows


def profile(fn, *args, calls=3):
    """Device time by kernel name over `calls` calls (a torch.profiler trace
    read with utils.profiling.trace_device_events), and the share of the
    window's host wall time that the device was busy. A trace without
    device time falls back to CUDA events around the calls."""
    from curve25519_tpu_torch.utils import profiling
    fn(*args)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        per = profiling.trace_device_events(logdir)
    busy = sum(v["total_us"] for v in per.values()) / 1e6
    if not per:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn(*args)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        ms = start.elapsed_time(end)
        return ("no device time in the trace; CUDA events %.3f ms/call, "
                "%.3f ms host wall" % (ms / calls, wall * 1e3))
    top = list(per.items())[:4]
    return "%s | device busy %.1f%% of %.3f ms host wall" % (
        ", ".join("%s %.3f ms/call" % (k[:40], v["total_us"] / 1e3 / calls)
                  for k, v in top), 100 * busy / wall, wall * 1e3)


# ---------------------------------------------------------------------------
# Phase 12: the rest of the single-device API
# ---------------------------------------------------------------------------
def ragged_launches(lengths, route):
    """The kernel launches of one ragged call over messages of `lengths`:
    per SHA-512 block bucket, the fused sign (one launch) or the composed
    one (3 SHA-512 and 1 base multiply); a verify check is one SHA-512 and
    one double-scalar multiply."""
    from curve25519_tpu_torch.ops.cuda import sign_kernel
    from curve25519_tpu_torch.utils import bucketing
    want = {}

    def add(k, n=1):
        want[k] = want.get(k, 0) + n

    for nb in bucketing.bucket_indices(lengths):
        if route == "sign" and sign_kernel.max_fused_msg_len(
                bucketing.bucket_length(nb)):
            add("sign_kernel")
        elif route == "sign":
            add("sha512_kernel", 3)
            add("basemult_kernel")
        else:
            add("sha512_kernel")
            add(route)
    return want


def phase_api(dev, rng, card, counts):
    lines = phase_ragged(dev, rng, card, counts)
    lines += phase_oo(dev, rng, card, counts)
    lines += phase_host_and_selftest(dev, rng)
    for line in lines:
        print("phase 12 " + line)


def phase_ragged(dev, rng, card, counts, n=RAGGED_MSGS):
    from curve25519_tpu_torch.models import blinding, ed25519
    from curve25519_tpu_torch.utils import bucketing

    lengths = rng.integers(0, RAGGED_MAX + 1, n)
    flat = rng.bytes(int(lengths.sum()))
    ofs = np.concatenate([[0], np.cumsum(lengths)])
    msgs = [flat[ofs[i]:ofs[i + 1]] for i in range(n)]
    nbuckets = len(bucketing.bucket_indices(lengths))
    check(nbuckets == 10, "%d buckets, expected 10" % nbuckets)
    seeds = rand_bytes(rng, (n, 32), dev)
    pk, priv = ed25519.create_keypair(seeds)
    ctx_bl = blinding.blinding_init(b"chip-smoke ragged", device=dev)
    lines = []

    def path(label, launched, fn, *args, **kw):
        out, wall, got = counts.drive(lambda: fn(*args, **kw))
        others = {k: v for k, v in got.items() if k not in launched}
        check(all(got[k] == v for k, v in launched.items())
              and not any(others.values()), "%s launched %s, expected %s"
              % (label, got, launched))
        # a second call, warm, for the rate
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args, **kw)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        lines.append("ragged %s: %d messages, host wall %.3f s (warm %.3f s, "
                     "%.0f messages/s) (%s)" % (
                         label, n, wall, warm, n / warm, ", ".join(
                             "%s %d" % kv for kv in sorted(launched.items())
                             if kv[1])))
        return out

    want_sign = ragged_launches(lengths, "sign")
    sig = path("sign_ragged", want_sign, ed25519.sign_ragged, priv, msgs)
    padded = np.zeros((n, RAGGED_MAX), np.uint8)
    for i, m in enumerate(msgs):
        padded[i, :len(m)] = np.frombuffer(m, np.uint8)
    msg_len = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    check(torch.equal(sig, ed25519.sign(priv, torch.from_numpy(padded).to(dev),
                                        msg_len)),
          "sign_ragged != the padded-batch sign")
    sample = [int(np.argmin(lengths)), int(np.argmax(lengths)), 1, n // 2,
              n - 1]
    for i in sample:
        check(row_bytes(sig[i]) == oracle_ed25519_sign(
            row_bytes(seeds[i]), row_bytes(pk[i]), msgs[i]),
            "ragged lane %d (%d bytes) disagrees with the Python oracle"
            % (i, lengths[i]))
    sig_bl = path("sign_ragged blinded", want_sign, ed25519.sign_ragged,
                  priv, msgs, blinding=ctx_bl)
    check(torch.equal(sig_bl, sig), "the blinded ragged sign changed a "
          "signature")

    bad = [3, n // 3, n - 2]
    sig[bad[0], 0] ^= 1                           # R
    sig[bad[1], 40] ^= 1                          # S
    sig[bad[2]] = sig[bad[2] - 1]                 # another message's
    want = torch.ones(n, dtype=torch.bool, device=dev)
    want[bad] = False
    checks = ragged_launches(lengths, "poly_kernel")
    got = path("verify_ragged", dict(checks, verify_init_kernel=1),
               ed25519.verify_ragged, sig, pk, msgs)
    check(torch.equal(got, want), "verify_ragged: %d of %d lanes wrong"
          % (int((got != want).sum()), n))
    ctx = ed25519.verify_init(pk)
    got = path("verify_ragged given a ctx", checks, ed25519.verify_ragged,
               sig, None, msgs, ctx=ctx)
    check(torch.equal(got, want), "verify_ragged with a ctx: lanes wrong")

    sig1 = ed25519.sign_ragged(priv[0], msgs)
    sig1[bad[0], 63] ^= 1
    shared = ragged_launches(lengths, "poly_shared_kernel")
    got = path("verify_ragged one key", dict(shared, verify_init_kernel=1),
               ed25519.verify_ragged, sig1, pk[0], msgs)
    want1 = torch.ones(n, dtype=torch.bool, device=dev)
    want1[bad[0]] = False
    check(torch.equal(got, want1), "verify_ragged of one key: lanes wrong")
    lines.append("ragged checks: %d buckets; sign_ragged == the padded-batch "
                 "sign and the Python oracle on %d lanes, blinded unchanged; "
                 "verify_ragged true on every valid lane, false on the %d "
                 "tampered" % (nbuckets, len(sample), len(bad)))

    # where a ragged call's time goes: the host's bucket packing alone (a
    # function that returns the lengths), then the device in a trace
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bucketing.apply_bucketed(lambda m, l: l, msgs, device=dev)
    torch.cuda.synchronize()
    lines.append("ragged bucket packing alone (host, to the card): %.3f s"
                 % (time.perf_counter() - t0))
    for label, fn, args in (
            ("sign_ragged", ed25519.sign_ragged, (priv, msgs)),
            ("verify_ragged given a ctx",
             lambda *a: ed25519.verify_ragged(*a, ctx=ctx),
             (sig, None, msgs))):
        lines.append("ragged profile [%s]: %s, 3 calls: %s"
                     % (card, label, profile(fn, *args)))
    return lines


def median_ms(fn, calls=OO_CALLS):
    """Median host wall time of `calls` calls, the card synchronized
    around each."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_oo(dev, rng, card, counts):
    from curve25519_tpu_torch import oo

    a_sk, b_sk, seed = rng.bytes(32), rng.bytes(32), rng.bytes(32)
    msg = rng.bytes(64)
    routes = {"card": {}, "host core": {"native": True}}
    out = {}
    for name, kw in routes.items():
        def run():
            a = oo.X25519Private(a_sk, **kw)
            b_pk = oo.X25519Private(b_sk, **kw).get_public_key()
            k = oo.ED25519Private(seed, **kw)
            sig = k.sign(msg)
            pub = oo.ED25519Public(k.get_public_key(), **kw)
            bad = sig[:5] + bytes([sig[5] ^ 1]) + sig[6:]
            return (a.get_public_key(), b_pk, a.create_shared_key(b_pk, False),
                    a.create_shared_key(b_pk), k.get_public_key(), sig,
                    pub.verify(sig, msg), pub.verify(bad, msg))
        out[name], _, got = counts.drive(run)
        if name == "card":
            for k in ("x25519_ladder_kernel", "keygen_kernel", "sign_kernel",
                      "sha512_kernel", "verify_init_kernel",
                      "poly_shared_kernel"):
                check(got[k] > 0, "the oo card route launched no %s" % k)
        else:
            check(not any(got.values()), "the host-core route launched %s"
                  % got)
    check(out["card"] == out["host core"], "the oo card and host-core routes "
          "disagree")
    check(out["card"][6] is True and out["card"][7] is False,
          "oo verify verdicts wrong")
    check(out["card"][5] == oracle_ed25519_sign(seed, out["card"][4], msg),
          "oo signature disagrees with the Python oracle")

    lat, profiles = {}, []
    for name, kw in routes.items():
        a = oo.X25519Private(a_sk, **kw)
        k = oo.ED25519Private(seed, **kw)
        sig = k.sign(msg)
        pub = oo.ED25519Public(k.get_public_key(), **kw)
        pub.verify(sig, msg)
        b_pk = out[name][1]
        ops = {"create_shared_key": (a.create_shared_key, b_pk),
               "ED25519Private()": (lambda s: oo.ED25519Private(s, **kw),
                                    seed),
               "sign": (k.sign, msg),
               "verify": (pub.verify, sig, msg)}
        lat[name] = {op: median_ms(lambda: f(*args))
                     for op, (f, *args) in ops.items()}
        if name == "card":
            profiles += ["oo profile [%s]: card %s, 3 calls: %s"
                         % (card, op, profile(*fa)) for op, fa in ops.items()]
    return ["oo: card and host-core routes equal (public keys, raw and KDF "
            "shared secrets, signature, verdicts)"] + [
        "oo single-op latency [%s], %s, median of %d ms: %s" % (
            card, name, OO_CALLS, ", ".join("%s %.3f" % kv
                                            for kv in lat[name].items()))
        for name in routes] + profiles


def phase_host_and_selftest(dev, rng):
    from curve25519_tpu_torch.models import ed25519
    from curve25519_tpu_torch.ops import sc
    from curve25519_tpu_torch.ops.sha512 import Sha512
    from curve25519_tpu_torch.tools import custom_tool
    from curve25519_tpu_torch.utils import checkpoint
    lines = []

    # the streaming SHA-512: 64 MiB on the host core, a few KiB on the card
    data = rng.bytes(64 << 20)
    h, ofs, pieces = Sha512(), 0, [1, 127, 128, 129, 4093, 65537,
                                   (1 << 20) + 3]
    t0 = time.perf_counter()
    while ofs < len(data):
        step = pieces[ofs % len(pieces)]
        h.update(data[ofs:ofs + step])
        ofs += step
    host = h.final()
    wall = time.perf_counter() - t0
    check(host == hashlib.sha512(data).digest(), "Sha512() != hashlib")
    small = data[:3000]
    t0 = time.perf_counter()
    hd = Sha512(device=dev)
    for a, b in ((0, 1), (1, 129), (129, 1000), (1000, 3000)):
        hd.update(small[a:b])
        check(len(hd._tail) < 128, "the streaming tail grew past a block")
    check(hd.final() == hashlib.sha512(small).digest(),
          "Sha512(device=cuda) != hashlib")
    lines.append("Sha512 streaming == hashlib: host core 64 MiB in uneven "
                 "pieces %.3f s (%.0f MB/s); card 3,000 bytes %.3f s"
                 % (wall, len(data) / wall / 1e6, time.perf_counter() - t0))

    # the mod-l selftest ops against Python integers
    xb = rand_bytes(rng, (SC_LANES, 32), dev)
    eb = rand_bytes(rng, (SC_LANES, 32), dev)
    x = sc.from_bytes(xb)
    xs = [int.from_bytes(row_bytes(r), "little") % ELL for r in xb]
    es = [int.from_bytes(row_bytes(r), "little") for r in eb]

    def ints(t):
        return [int.from_bytes(row_bytes(r), "little") for r in sc.to_bytes(t)]

    t0 = time.perf_counter()
    got = {"inv": ints(sc.inv(x)),
           "to_mont": ints(sc.to_mont(x)),
           "mont_mul": ints(sc.mont_mul(sc.to_mont(x), sc.to_mont(x))),
           "from_mont": ints(sc.from_mont(sc.to_mont(x))),
           "exp_mod_bpo": ints(sc.exp_mod_bpo(x, eb))}
    wall = time.perf_counter() - t0
    want = {"inv": [pow(v, ELL - 2, ELL) for v in xs],
            "to_mont": [v * 2**256 % ELL for v in xs],
            "mont_mul": [v * v * 2**256 % ELL for v in xs],
            "from_mont": xs,
            "exp_mod_bpo": [pow(v, e, ELL) for v, e in zip(xs, es)]}
    for k in want:
        check(got[k] == want[k], "sc.%s disagrees with Python integers" % k)
    lines.append("sc.inv, to_mont / mont_mul / from_mont, exp_mod_bpo at %d "
                 "lanes on the card == Python integers (%.3f s)"
                 % (SC_LANES, wall))

    # a verify context through a checkpoint
    pk, priv = ed25519.create_keypair(rand_bytes(rng, (CTX_KEYS, 32), dev))
    msg = rand_bytes(rng, (CTX_KEYS, 64), dev)
    sig = ed25519.sign(priv, msg)
    sig[CTX_KEYS // 2, 9] ^= 1
    ctx = ed25519.verify_init(pk)
    before = ed25519.verify_check(ctx, sig, msg)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_verify_ctx(Path(d) / "ctx", ctx)
        back = checkpoint.load_verify_ctx(Path(d) / "ctx")
    check(all(back[k].is_cuda and torch.equal(back[k], ctx[k])
              for k in ("pk", "planes", "ok")), "the reloaded ctx differs")
    after = ed25519.verify_check(back, sig, msg)
    check(torch.equal(after, before) and int((~before).sum()) == 1,
          "verdicts changed across the checkpoint")
    lines.append("checkpoint: a verify ctx of %d keys saved and loaded, the "
                 "same verdicts" % CTX_KEYS)

    rc = custom_tool.main(["t", "chip-smoke seed", "chip-smoke message"])
    check(rc == 0, "custom_tool t exited %d" % rc)
    lines.append("custom_tool t: 0 (refmodel, the card, the host core)")
    return lines


# ---------------------------------------------------------------------------
# Phase 13: the multi-device path (parallel/mesh.py)
# ---------------------------------------------------------------------------
def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(cmds):
    """Run the commands side by side from the repo root; returns each one's
    (exit code, output). Fails if one has not ended after
    SUBPROCESS_TIMEOUT seconds; every process is ended on the way out."""
    root = Path(__file__).resolve().parent
    procs = [subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    try:
        outs = [p.communicate(timeout=SUBPROCESS_TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        fail("%s did not end within %d s" % (cmds, SUBPROCESS_TIMEOUT))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def phase_mesh(dev, rng, card, counts, batch=MAIN_BATCH):
    import torch.distributed as dist
    from curve25519_tpu_torch.models import ed25519, x25519
    from curve25519_tpu_torch.parallel import mesh as pmesh

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d"
                            % free_port(), world_size=1, rank=0,
                            timeout=pmesh.TIMEOUT)
    try:
        m = pmesh.make_pod_mesh()
        check(dist.get_backend(m.group) == "nccl" and m.size == 1,
              "the pod mesh is %s" % (m,))
        sk_a, sk_b, msgs = (rand_bytes(rng, (batch, w), dev)
                            for w in (32, 32, 64))
        step = pmesh.mixed_throughput_step(m)
        args = [pmesh.shard_batch(x, m) for x in (sk_a, sk_b, msgs)]
        (ok, ops, shared), wall, got = counts.drive(step, *args)
        per_shard = {"x25519_ladder_kernel": 4, "keygen_kernel": 1,
                     "sign_kernel": 1, "sha512_kernel": 1,
                     "oneshot_kernel": 1}
        want = {k: per_shard.get(k, 0) * m.size for k in got}
        check(got == want, "the mesh step launched %s, expected %s"
              % (got, want))
        check(ok.device == dev and ok.dtype == torch.int64,
              "the counters are %s on %s" % (ok.dtype, ok.device))
        check(int(ok) == int(ops) == 2 * batch,
              "ok %d, ops %d, expected %d" % (int(ok), int(ops), 2 * batch))
        ref = x25519.create_shared_key(x25519.calculate_public_key(sk_b),
                                       sk_a)
        check(torch.equal(torch.cat(shared), ref),
              "shared_a differs from create_shared_key outside the mesh")
        print("phase 13 mesh step: NCCL, world size 1 (%d card(s) seen), "
              "B = %d, 64-byte messages, %.3f s wall, launches %s; ok = "
              "ops = %d; shared_a == create_shared_key outside the mesh"
              % (torch.cuda.device_count(), batch, wall,
                 {k: v for k, v in got.items() if v}, 2 * batch))

        def direct():
            """The step's seven calls on the whole batch, no mesh."""
            a_pk = x25519.calculate_public_key(sk_a)
            b_pk = x25519.calculate_public_key(sk_b)
            s_ab = x25519.create_shared_key(b_pk, sk_a)
            s_ba = x25519.create_shared_key(a_pk, sk_b)
            pk, priv = ed25519.create_keypair(sk_a)
            sig_ok = ed25519.verify(ed25519.sign(priv, msgs), pk, msgs)
            return (s_ab == s_ba).all(-1).sum() + sig_ok.sum()

        def host_s(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        calls = {"mesh": lambda: step(*args), "direct": direct}
        times = {"mesh": [], "direct": []}
        for order in (("mesh", "direct"), ("direct", "mesh")) * 2:
            for name in order:
                times[name].append(host_s(calls[name]))
        step_s, direct_s = min(times["mesh"]), min(times["direct"])
        print("phase 13 mesh timing [%s]: B = %d, step %.3f ms (%.1f "
              "protocol ops/s, best of 4 warm, host wall) | the seven calls "
              "without the mesh %.3f ms | step / calls %.4f"
              % (card, batch, step_s * 1e3, 2 * batch / step_s,
                 direct_s * 1e3, step_s / direct_s))
        print("phase 13 profile [%s]: mesh step B=%d, 3 calls: %s"
              % (card, batch, profile(step, *args)))
    finally:
        dist.destroy_process_group()
    phase_mesh_processes(dev)
    phase_examples()


def phase_mesh_processes(dev, lanes=MP_LANES):
    """Two gloo ranks on one card through tests/torch_mp_worker.py."""
    from curve25519_tpu_torch.models import x25519

    root = Path(__file__).resolve().parent
    worker = root / "tests" / "torch_mp_worker.py"
    spec = importlib.util.spec_from_file_location("torch_mp_worker", worker)
    mp_worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mp_worker)
    port = free_port()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        results = run_processes([
            [sys.executable, str(worker), str(pid), "2", str(port), "1",
             "--device", "cuda", "--lanes", str(lanes), "--msg-len", "64",
             "--out", out] for pid in range(2)])
        wall = time.perf_counter() - t0
        ok_line = "TORCH_MP_OK ok=%d ops=%d procs=2 devs=2" % (2 * lanes,
                                                               2 * lanes)
        for pid, (rc, text) in enumerate(results):
            check(rc == 0 and ok_line in text, "worker %d exited %d:\n%s"
                  % (pid, rc, text[-3000:]))
        shards = [np.load(Path(out) / ("shared_%d.npy" % i))
                  for i in range(2)]
    sk_a, sk_b, _ = (torch.from_numpy(x).to(dev)
                     for x in mp_worker.inputs(lanes, 64))
    ref = x25519.create_shared_key(x25519.calculate_public_key(sk_b),
                                   sk_a).cpu().numpy()
    half = lanes // 2
    for i, shard in enumerate(shards):
        check(np.array_equal(shard, ref[i * half:(i + 1) * half]),
              "gloo rank %d's shard differs from the single-process bytes"
              % i)
    print("phase 13 two gloo ranks on one card: B = %d, %s on each rank, "
          "each shard == the single-process bytes, %.1f s wall"
          % (lanes, ok_line, wall))


def phase_examples():
    root = Path(__file__).resolve().parent
    for name, *args in EXAMPLES:
        t0 = time.perf_counter()
        [(rc, text)] = run_processes(
            [[sys.executable, str(root / "examples" / name), *args]])
        check(rc == 0, "examples/%s exited %d:\n%s" % (name, rc,
                                                        text[-3000:]))
        print("phase 13 example %s: exit 0 in %.1f s | %s"
              % (name, time.perf_counter() - t0,
                 text.strip().splitlines()[-1]))


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    root = Path(__file__).resolve().parent
    for src, _, _ in KERNELS.values():
        check((root / CSRC / src).exists(),
              "%s%s not found next to this script: run it from a checkout"
              % (CSRC, src))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    card = phase_device()
    build_info = phase_build()
    counts = Counts()
    ladder_err = phase_ladder_vs_plain(dev, rng)
    phase_x25519_known_answers(dev, rng)
    rows = {"x25519_ladder_kernel": phase_x25519_main(dev, rng, card, counts)}
    errs = phase_ed_kernels_vs_plain(dev, rng)
    phase_ed_known_answers(dev, rng)
    rows.update(phase_ed_main(dev, rng, card, counts))
    errs.update(phase_verify_kernels_vs_plain(dev, rng))
    phase_verify_known_answers(dev, rng)
    rows.update(phase_verify_main(dev, rng, card, counts))
    phase_api(dev, rng, card, counts)
    phase_mesh(dev, rng, card, counts)
    check("jax" not in sys.modules and "curve25519_tpu" not in sys.modules,
          "the port imported jax or the JAX package")

    rows["x25519_ladder_kernel"]["max_abs_err"] = max(
        rows["x25519_ladder_kernel"]["max_abs_err"], ladder_err)
    kernels = []
    for name, (src, replaces, entries) in KERNELS.items():
        row = rows[name]
        check(counts.total[name] > 0, "%s was launched 0 times on the main "
              "paths" % name)
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "launches": counts.total[name],
            "max_abs_err": max(row["max_abs_err"], errs.get(name, 0)),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
            "registers": max(build_info[k]["registers"] for k in entries),
        })
    print("chip_smoke wall time: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
