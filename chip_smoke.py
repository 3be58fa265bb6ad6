#!/usr/bin/env python3
"""Smoke run of the PyTorch port (curve25519_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc
(/usr/local/cuda or CUDA_HOME) and PyTorch built for CUDA. It imports
nothing of JAX or of the JAX package. Phases, each printing a line:

1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
2. the nvcc build of the CUDA ladder kernel from csrc/, with its build
   seconds, registers per thread and spill bytes;
3. kernel against its plain PyTorch version on the card, byte for byte:
   random lanes, the RFC 7748 edge u values, an all-zero peer, a nonzero zr,
   ragged batches, rank-1 and broadcast calls;
4. known answers: RFC 7748 5.2 and 6.1 vectors, and random lanes against an
   independent Python-integer X25519;
5. the main path at full size: 262,144 lanes of key exchange through
   models.x25519 (both public keys, both shared secrets), which must agree on
   every lane and must have launched the kernel; then create_shared_key timed
   with CUDA events against the plain version at the same batch.

It prints a JSON line of the kernels, then, as its last line,
{"ok": true, "device": {...}}. Any failed check exits non-zero before that.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 7748
MAIN_BATCH = 262_144          # the batch of bench.py's headline
CHECK_LANES = 4096
ORACLE_LANES = 4
KERNEL_SOURCE = "curve25519_tpu_torch/ops/cuda/csrc/ladder.cu"
REPLACES = "curve25519_tpu/ops/pallas/ladder_kernel.py:30"

P = 2**255 - 19

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

# benchmarks/tpu_vectors.py x25519_edge_u: u values with key 0x07 * 32
EDGE_U = [0, 1, P, P + 1, 2**255 - 1, 1 | 1 << 255]


def fail(msg):
    raise SystemExit("chip_smoke FAILED: " + msg)


def check(cond, msg):
    if not cond:
        fail(msg)


def oracle_x25519(k: bytes, u: bytes) -> bytes:
    """RFC 7748 section 5 X25519 on Python integers: an oracle independent of
    the limb code under test."""
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


def hex_bytes(s, device):
    return torch.tensor(list(bytes.fromhex(s)), dtype=torch.uint8,
                        device=device)


def row_bytes(t):
    return bytes(t.cpu().tolist())


def max_abs_err(a, b):
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item())


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device():
    card = card_line()
    print(card)
    print("phase 1 device: %s | torch %s | CUDA %s | python %s"
          % (torch.cuda.get_device_name(0), torch.__version__,
             torch.version.cuda, sys.version.split()[0]))
    return card


def phase_build():
    from curve25519_tpu_torch.ops.cuda import build
    info = build.build_cuda()
    build.load_cuda()
    check("registers" in info, "ptxas report not found in the nvcc log")
    print("phase 2 build: nvcc %.1f s | %d registers/thread | spill stores "
          "%d B, spill loads %d B, stack %d B"
          % (info["build_seconds"], info["registers"],
             info.get("spill_store_bytes", -1),
             info.get("spill_load_bytes", -1), info.get("stack_bytes", -1)))
    return info


def phase_kernel_vs_plain(dev, rng, lanes=CHECK_LANES):
    from curve25519_tpu_torch.config import int_to_limbs
    from curve25519_tpu_torch.models import montgomery
    from curve25519_tpu_torch.ops.cuda.ladder_kernel import point_multiply_cuda

    u = torch.from_numpy(rng.integers(0, 256, (lanes, 32), np.uint8)).to(dev)
    k = torch.from_numpy(rng.integers(0, 256, (lanes, 32), np.uint8)).to(dev)
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
    print("phase 3 kernel vs plain: %d random lanes, %d edge u, zero peer, "
          "zr, ragged 1/127/129/1000, rank-1, broadcast: byte-equal "
          "(max_abs_err %d)" % (lanes, len(EDGE_U), err))
    return err


def phase_known_answers(dev, rng):
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
    print("phase 4 known answers: RFC 7748 5.2 (2), 6.1 (pk, pk, shared), "
          "%d random lanes vs the Python-integer oracle: ok" % ORACLE_LANES)


def phase_main(dev, rng, card, batch=MAIN_BATCH):
    from curve25519_tpu_torch.models import montgomery, x25519
    from curve25519_tpu_torch.ops.cuda import ladder_kernel
    from curve25519_tpu_torch.utils.profiling import bench

    sk_a = torch.from_numpy(rng.integers(0, 256, (batch, 32), np.uint8)).to(dev)
    sk_b = torch.from_numpy(rng.integers(0, 256, (batch, 32), np.uint8)).to(dev)
    torch.cuda.synchronize()

    ladder_kernel.launches = 0
    t0 = time.perf_counter()
    pk_a = x25519.calculate_public_key(sk_a)
    pk_b = x25519.calculate_public_key(sk_b)
    s_ab = x25519.create_shared_key(pk_b, sk_a)
    s_ba = x25519.create_shared_key(pk_a, sk_b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ladder_kernel.launches

    check(launches > 0, "the main path launched the ladder kernel 0 times")
    check(s_ab.shape == (batch, 32) and s_ab.dtype == torch.uint8,
          "shared secret has shape %s %s" % (tuple(s_ab.shape), s_ab.dtype))
    check(torch.equal(s_ab, s_ba), "shared secrets differ on %d of %d lanes"
          % (int((s_ab != s_ba).any(-1).sum()), batch))
    for i in range(ORACLE_LANES):
        check(row_bytes(s_ab[i]) == oracle_x25519(
            row_bytes(sk_a[i]), row_bytes(pk_b[i])),
            "main-path lane %d disagrees with the Python oracle" % i)
    print("phase 5 main path: %d lanes, 2 x calculate_public_key + 2 x "
          "create_shared_key in %.3f s wall, %d kernel launches, secrets "
          "agree on every lane" % (batch, wall, launches))

    kernel_s = bench(x25519.create_shared_key, pk_b, sk_a, reps=3, rounds=3)
    montgomery.point_multiply(pk_b[:8], sk_a[:8])   # warm the plain path
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = montgomery.point_multiply(pk_b, sk_a)
    end.record()
    end.synchronize()
    plain_s = start.elapsed_time(end) / 1e3
    err = max_abs_err(plain, s_ab)
    check(err == 0, "plain != kernel at the main batch")
    print("phase 5 timing [%s]: create_shared_key B=%d kernel %.3f ms "
          "(%.1f ops/s, best of 3 x 3 after warm-up) | plain PyTorch %.3f ms "
          "(%.1f ops/s, one call) | byte-equal"
          % (card, batch, kernel_s * 1e3, batch / kernel_s, plain_s * 1e3,
             batch / plain_s))
    return {"launches": launches, "max_abs_err": err,
            "ms": kernel_s * 1e3, "plain_ms": plain_s * 1e3}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    root = Path(__file__).resolve().parent
    check((root / KERNEL_SOURCE).exists(),
          "%s not found next to this script: run it from a checkout"
          % KERNEL_SOURCE)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    card = phase_device()
    phase_build()
    check_err = phase_kernel_vs_plain(dev, rng)
    phase_known_answers(dev, rng)
    main_row = phase_main(dev, rng, card)
    check("jax" not in sys.modules and "curve25519_tpu" not in sys.modules,
          "the port imported jax or the JAX package")

    kernel = {"name": "x25519_ladder_kernel", "route": "cuda",
              "source": KERNEL_SOURCE, "replaces": REPLACES, **main_row}
    kernel["max_abs_err"] = max(kernel["max_abs_err"], check_err)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
