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
3. the card's byte-equality checks: the `cuda` cases of
   tests/test_torch_cuda.py (every kernel against its plain version, the
   RFC 7748 / RFC 8032 / hashlib known answers, the edge encodings, the
   verify paths and the ragged batches) in a subprocess,
       python -m pytest --noconftest -p no:cacheprovider -m cuda
           tests/test_torch_cuda.py
   on the libraries phase 2 built; all 11 cases must run and pass;
4. the X25519 main path at full size: 262,144 lanes of key exchange through
   models.x25519, which must agree on every lane, must match the
   Python-integer reference (portbench/reference/curve.py) on a few lanes
   and must have launched the kernel; then create_shared_key timed and held
   equal to the plain version;
5. the Ed25519 paths at full size, each driven with every launch count set
   to 0 just before it and read just after: keygen, sign of 64-byte
   messages, the same sign blinded, calculate_public_key_fast with fold 8
   and fold 4 (held equal to the ladder's calculate_public_key on all
   lanes), sha512 of 64-byte messages, and the long-message sign (1,024
   lanes, 944-4,096 bytes, held equal to the plain version), the SHA-512
   packing kernel counted on each; then each kernel timed at the same
   batch and held equal to one untimed call of its plain version there:
   the packing kernel at the verify and TLS shapes (165,000 x 1,167 bytes
   behind a 64-byte prefix; 262,144 x 130 behind 32- and 64-byte zero holes
   broadcast from one row), the digits kernel at 262,144 and 165,000 lanes
   against its 480 bytes a lane, one call of each base-multiply limb-mode
   kernel (on no main path); and SHA-512 of 1,024 messages of up to 1 MiB
   (the reference's sha512_long shape) against hashlib on a few lanes;
6. the verify paths at full size (262,144 distinct keys, 64-byte
   messages), each driven with the launch counts set to 0 just before it
   and read just after: verify_init, verify_check against that context,
   verify_check of one key's signatures against its unbatched context, the
   one-shot verify, and verify_cached against a context of every other
   lane's key (the rest missed); every valid lane must verify and every
   tampered lane fail; then each verify kernel timed and held equal to its
   plain version (the lookup and the keyed kernel against a table of 1,500
   keys), and the one-shot kernel against Verify_Init and the multiply
   back to back;
7. the rest of the single-device API on the card: sign_ragged and
   verify_ragged of 65,536 messages of 0-1,200 bytes (10 SHA-512 block
   buckets; sign, sign blinded, verify, verify given a ctx, one key's
   verify), each with its launches counted, its verdicts checked and its
   warm rate, then the host's bucket packing alone and a profile of each;
   the OO wrapper's card route against its host-core route, with the
   single-op latency of each (median of 50 calls) and a profile of each
   card op; the streaming
   Sha512 on the host core (64 MiB) and on the card, against hashlib;
   sc.inv, to_mont / mont_mul / from_mont and exp_mod_bpo at 4,096 lanes
   against Python integers; a verify context of 16,384 keys saved and
   loaded; and the custom tool's test vector (`t`) on the card;
8. the multi-device path (parallel/mesh.py): mixed_throughput_step over
   make_pod_mesh() in this process, with a real NCCL process group at the
   world size of one process, at 262,144 lanes of 64-byte messages, driven
   with the launch counts set to 0 just before it and read just after
   (per shard: 4 ladder, 1 keygen, 1 sign, 1 SHA-512, 3 packings, 1
   digits, 1 one-shot verify);
   both counters must be 2B and shared_a the bytes of create_shared_key
   run outside the mesh; the warm step timed against the same seven calls
   made without the mesh, and profiled; then two worker processes sharing the card in a
   gloo group (tests/torch_mp_worker.py, 2 x 4,096 lanes), whose shards
   must be the single-process bytes; then the three examples/torch_*.py as
   subprocesses, each of which must exit 0.

Each timing prints the frozen bound of its work (portbench/bound.py: the
larger of its bytes and its operations at an H100 SXM's rates) and its
share of it; a share over 100% fails the run.

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
from collections import Counter
from pathlib import Path
from xml.etree import ElementTree

import numpy as np
import torch

from portbench import bound
from portbench.reference import curve

SEED = 7748
MAIN_BATCH = 262_144          # the batch of bench.py's headline
ORACLE_LANES = 4
LONG_LANES = 1024             # the long-message sign route
LONG_SHA_LANES = 1024         # the long-message SHA-512 row (1 MiB each)
CSRC = "curve25519_tpu_torch/ops/cuda/csrc/"
CARD_TESTS = "tests/test_torch_cuda.py"
CARD_TESTS_N = 11             # phase 3: its `cuda` cases, every one run
CARD_TESTS_TIMEOUT = 600      # phase 3: seconds for the card's tests
RAGGED_MSGS = 65_536          # phase 7: messages of 0-1,200 bytes
RAGGED_MAX = 1200
VOTE_KEYS = 1_500             # phase 6: the keyed kernel's table of keys
CTX_KEYS = 16_384             # phase 7: the saved verify context
SC_LANES = 4096               # phase 7: the mod-l selftest ops
OO_CALLS = 50                 # phase 7: calls per single-op latency
MP_LANES = 2 * 4096           # phase 8: lanes of the two gloo ranks
SUBPROCESS_TIMEOUT = 300      # phase 8: seconds for a worker or an example
# phase 8: the examples and their arguments
EXAMPLES = (("torch_dh_exchange.py",), ("torch_streaming_and_ragged.py",),
            ("torch_throughput_server.py", "3"))
PALLAS = "curve25519_tpu/ops/pallas/"
# kernel -> (source, the TPU kernel body it replaces, its entry functions in
# ptxas's report)
KERNELS = {
    "x25519_ladder_kernel": ("ladder.cu", PALLAS + "ladder_kernel.py:30",
                             ("x25519_ladder_kernel",)),
    "basemult_kernel": ("basemult.cu", PALLAS + "edwards_kernel.py:143",
                        ("basemult_fold8_kernel",
                         "basemult_fold8_limbs_kernel",
                         "basemult_fold4_kernel",
                         "basemult_fold4_limbs_kernel")),
    "sha512_kernel": ("sha512.cu", PALLAS + "sha512_kernel.py:101",
                      ("sha512_kernel",)),
    "pack_words_kernel": ("sha512.cu", PALLAS + "sha512_kernel.py:235",
                          ("pack_words_kernel",)),
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
    "poly_keyed_kernel": ("poly.cu", PALLAS + "verify_kernel.py:85",
                          ("poly_keyed_kernel",)),
    # no TPU kernel: verify_cached's lookup of each lane's key
    "key_lookup_kernel": ("poly.cu", "none", ("key_lookup_kernel",)),
    "oneshot_kernel": ("oneshot.cu", PALLAS + "verify_kernel.py:320",
                       ("oneshot_kernel",)),
    # no TPU kernel: the XLA ops of the JAX verify's fold digits
    "digits_kernel": ("digits.cu", "curve25519_tpu/models/ed25519.py:306",
                      ("digits_kernel",)),
}


def fail(msg):
    raise SystemExit("chip_smoke FAILED: " + msg)


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------
def row_bytes(t):
    return bytes(t.cpu().tolist())


def rand_bytes(rng, shape, dev):
    return torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)


def max_abs_err(a, b):
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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
        # kernels counted in a module attribute: (the module, its name)
        self.mods = {"x25519_ladder_kernel": (ladder_kernel, "launches"),
                     "basemult_kernel": (edwards_kernel, "launches"),
                     "sha512_kernel": (sha512_kernel, "launches"),
                     "pack_words_kernel": (sha512_kernel, "pack_launches")}
        # kernels counted in a module's launches dict: (the dict, its key)
        self.keyed = {"keygen_kernel": (sign_kernel.launches, "keygen"),
                      "sign_kernel": (sign_kernel.launches, "sign")}
        for key in verify_kernel.launches:
            self.keyed[key + "_kernel"] = (verify_kernel.launches, key)
        self.total = {k: 0 for k in KERNELS}

    def zero(self):
        for m, attr in self.mods.values():
            setattr(m, attr, 0)
        for d, key in self.keyed.values():
            d[key] = 0

    def read(self):
        got = {k: getattr(m, attr) for k, (m, attr) in self.mods.items()}
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
# Bounds: portbench/bound.py's frozen model, the one every roofline of the
# benchmark reads. Work is (field operation -> count, ALU operations) a
# lane, in bound.py's counts; keygen is its fold-8 base multiply and one
# SHA-512 block.
# ---------------------------------------------------------------------------
NO_OPS = (Counter(), 0)          # a kernel bound by its bytes alone


def keygen_ops():
    field, alu = bound.basemult_ops(8)
    return field, alu + bound.SHA_BLOCK_ALU


def bound_ms(work, lanes, nbytes):
    """(bound ms, "operations" or "bytes") of one call of `lanes` lanes of
    `work` reading and writing `nbytes`."""
    ms = bound.seconds([(work, lanes, nbytes)]) * 1e3
    return ms, ("bytes" if nbytes / bound.HBM_BYTES_PER_S * 1e3 >= ms
                else "operations")


def share(bms, ms, what):
    """bound / time; a share over 100% means the bound is wrong."""
    check(bms <= ms, "%s: bound %.3f ms over its time %.3f ms" % (what, bms,
                                                                  ms))
    return 100 * bms / ms


def time_kernels(cases, batch, card, phase):
    """Per case name: (kernel wrapper, plain version, args, work a lane,
    bytes). Times the wrapper (best of 3 x 3 after a warm-up), holds its
    output byte-equal to one untimed call of the plain version on the same
    args, and returns each kernel's row for the JSON line."""
    from curve25519_tpu_torch.utils.profiling import bench
    rows = {}
    for name, (kernel_fn, plain_fn, args, work, nbytes) in cases.items():
        kernel_s = bench(kernel_fn, *args, reps=3, rounds=3)
        err = max_abs_err(kernel_fn(*args), plain_fn(*args))
        check(err == 0, "%s != plain at the main batch" % name)
        bms, by = bound_ms(work, batch, nbytes)
        rows[name] = {"max_abs_err": err, "ms": kernel_s * 1e3,
                      "bound_ms": bms, "bound_by": by}
        print("phase %d timing [%s]: %s B=%d kernel %.3f ms (best of 3 x 3 "
              "after warm-up) | bound %.3f ms (%s), %.1f%% | == plain"
              % (phase, card, name, batch, kernel_s * 1e3, bms, by,
                 share(bms, kernel_s * 1e3, name)))
    return rows


# ---------------------------------------------------------------------------
# Phases 1-4: the card, the build, the card's tests, the X25519 main path
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


def phase_card_tests():
    """The cuda cases of tests/test_torch_cuda.py in a subprocess: all
    CARD_TESTS_N of them must run and pass, none may skip."""
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as d:
        xml = Path(d) / "cuda.xml"
        cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p",
               "no:cacheprovider", "-m", "cuda", CARD_TESTS, "-q",
               "--junitxml", str(xml)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, cwd=root, capture_output=True,
                                  text=True, timeout=CARD_TESTS_TIMEOUT)
        except subprocess.TimeoutExpired:
            fail("%s did not end within %d s" % (" ".join(cmd[1:]),
                                                 CARD_TESTS_TIMEOUT))
        wall = time.perf_counter() - t0
        out = proc.stdout + proc.stderr
        check(xml.exists(), "pytest wrote no report (exit %d):\n%s"
              % (proc.returncode, out[-6000:]))
        suite = next(ElementTree.parse(xml).getroot().iter("testsuite"))
    n = {k: int(suite.get(k, 0)) for k in ("tests", "failures", "errors",
                                           "skipped")}
    check(proc.returncode == 0 and n["tests"] == CARD_TESTS_N
          and n["failures"] == n["errors"] == n["skipped"] == 0,
          "the card's tests: %s, exit %d:\n%s" % (n, proc.returncode,
                                                  out[-6000:]))
    print("phase 3 card tests: %d passed, 0 failed, 0 skipped in %.1f s "
          "(pytest --noconftest -m cuda %s)" % (n["tests"], wall, CARD_TESTS))


def phase_x25519_main(dev, rng, card, counts, batch=MAIN_BATCH):
    from curve25519_tpu_torch.models import montgomery, x25519
    from curve25519_tpu_torch.ops.cuda import ladder_kernel
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
        check(row_bytes(s_ab[i]) == curve.x25519(
            row_bytes(sk_a[i]), row_bytes(pk_b[i])),
            "main-path lane %d disagrees with the Python oracle" % i)
    print("phase 4 X25519 main path: %d lanes, 2 x calculate_public_key + 2 x "
          "create_shared_key in %.3f s wall, %d kernel launches, secrets "
          "agree on every lane" % (batch, wall, launches))

    kernel_s = bench(x25519.create_shared_key, pk_b, sk_a, reps=3, rounds=3)
    err = max_abs_err(montgomery.point_multiply(pk_b, sk_a), s_ab)
    check(err == 0, "x25519_ladder_kernel != plain at the main batch")
    bms, by = bound_ms(bound.ladder_ops(), batch, batch * 96)
    print("phase 4 timing [%s]: create_shared_key B=%d kernel %.3f ms "
          "(%.1f ops/s, best of 3 x 3 after warm-up) | bound %.3f ms (%s), "
          "%.1f%% | == plain" % (card, batch, kernel_s * 1e3,
                                 batch / kernel_s, bms, by,
                                 share(bms, kernel_s * 1e3,
                                       "x25519_ladder_kernel")))
    lane = ladder_kernel.lane_products()
    check(lane["fp64"] > 0, "the ladder issues no product on the FP64 pipe")
    print("phase 4 ladder pipes: a lane issues %d limb products on the FP64 "
          "pipe and %d on IMAD.WIDE (%.1f%% on FP64)" % (
              lane["fp64"], lane["int"],
              100.0 * lane["fp64"] / (lane["fp64"] + lane["int"])))
    return {"max_abs_err": err, "ms": kernel_s * 1e3, "bound_ms": bms,
            "bound_by": by}


# ---------------------------------------------------------------------------
# Phase 5: base multiply, SHA-512, keygen, sign
# ---------------------------------------------------------------------------
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
        check(row_bytes(pk[i]) == curve.public_key(row_bytes(seeds[i])),
              "main-path pk lane %d disagrees with the Python oracle" % i)
    lines.append("create_keypair %.3f s (%s)" % (wall, got["keygen_kernel"]))

    # sign, plain and blinded
    sig, wall, got = counts.drive(ed25519.sign, priv, msg)
    check(got["sign_kernel"] == 1 and got["pack_words_kernel"] == 2,
          "sign launched %s" % got)
    for i in (0, batch - 1):
        check(row_bytes(sig[i]) == curve.sign(row_bytes(seeds[i]),
                                              row_bytes(msg[i])),
              "main-path signature lane %d disagrees with the Python oracle"
              % i)
    lines.append("sign %.3f s (%d, packing %d)"
                 % (wall, got["sign_kernel"], got["pack_words_kernel"]))
    sig_bl, wall, got = counts.drive(
        lambda: ed25519.sign(priv, msg, blinding=ctx))
    check(got["sign_kernel"] == 1 and got["pack_words_kernel"] == 2
          and torch.equal(sig_bl, sig),
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
    check(got["sha512_kernel"] == 1 and got["pack_words_kernel"] == 1,
          "sha512 launched %s" % got)
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
    check(got["sha512_kernel"] == 3 and got["pack_words_kernel"] == 3
          and got["basemult_kernel"] == 1 and got["sign_kernel"] == 0,
          "long sign launched %s" % got)
    check(torch.equal(sig_long, sgk.sign_plain(
        priv[:LONG_LANES], long, n_long, zr=blinding.default_zr(device=dev))),
        "long-message sign != plain")
    for i in (0, LONG_LANES - 1):
        check(row_bytes(sig_long[i]) == curve.sign(
            row_bytes(seeds[i]), row_bytes(long[i, :int(n_long[i])])),
            "long-message lane %d disagrees with the Python oracle" % i)
    lines.append("long sign %d lanes of 944-4,096 bytes %.3f s (sha512 %d, "
                 "basemult %d)" % (LONG_LANES, wall, got["sha512_kernel"],
                                   got["basemult_kernel"]))
    print("phase 5 Ed25519 main paths, B = %d (launches): %s"
          % (batch, "; ".join(lines)))

    # timing: each kernel's wrapper on the inputs of the path, best of 3 x 3
    # after a warm-up
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
            bound.basemult_ops(8), batch * (128 + 32)),
        "basemult_kernel.fold4": (
            lambda c: ek.base_mult(c, mode="u_bytes", nfolds=4),
            lambda c: ek.base_mult_plain(c, mode="u_bytes", nfolds=4), (cut4,),
            bound.basemult_ops(4), batch * (256 + 32)),
        "sha512_kernel": (shk.sha512_blocks, shk.sha512_blocks_plain,
                          (words, nblocks), (Counter(), bound.SHA_BLOCK_ALU),
                          batch * (128 + 4 + 64)),
        "keygen_kernel": (
            lambda s: sgk.keygen(s, zr=zr),
            lambda s: sgk.keygen_plain(s, zr=zr), (seeds,), keygen_ops(),
            batch * (32 + 32)),
        "sign_kernel": (
            lambda p, m, n: sgk.sign_fused(p, m, n, zr=zr),
            lambda p, m, n: sgk.sign_plain(p, m, n, zr=zr), (priv, msg, ml),
            bound.sign_ops(w3_blocks), batch * (64 + 64 + 4 + 64)),
    }
    rows = time_kernels(cases, batch, card, 5)
    rows.update(time_pack_words(dev, rng, card))
    rows.update(time_digits(dev, rng, card))
    rows.update(time_limb_modes(cut8, cut4, card))
    time_long_sha512(dev, card)
    for label, fn, args in (
            ("create_keypair", ed25519.create_keypair, (seeds,)),
            ("sign", ed25519.sign, (priv, msg)),
            ("calculate_public_key_fast", x25519.calculate_public_key_fast,
             (seeds,)),
            ("sha512", sha512.sha512, (msg,))):
        print("phase 5 profile [%s]: %s B=%d, 3 calls: %s"
              % (card, label, batch, profile(fn, *args)))
    return rows


def time_pack_words(dev, rng, card):
    """The packing kernel against its plain version at the main paths'
    shapes: a verify batch of 165,000 packets of up to 1,167 bytes behind
    R || pk (64 bytes), and sign's two packings of a TLS batch, 262,144
    messages of up to 130 bytes behind a 32- and a 64-byte zero hole
    broadcast from one row. Lengths random in [0, L] with the block edges;
    the bound counts each byte read or written once (a broadcast row once).
    Returns the verify shape's row under pack_words_kernel."""
    from curve25519_tpu_torch.ops import sha512

    def pack(fn):
        return lambda m, n, p: fn(m, n, p)[:2]

    rows = {}
    zero = torch.zeros((1, 64), dtype=torch.uint8, device=dev)
    for name, n, width, prefix, hole in (
            ("pack_words_kernel", 165_000, 1167, 64, False),
            ("pack_words_kernel.tls_w2", MAIN_BATCH, 130, 32, True),
            ("pack_words_kernel.tls_w3", MAIN_BATCH, 130, 64, True)):
        msg = rand_bytes(rng, (n, width), dev)
        lengths = rng.integers(0, width + 1, n).astype(np.int32)
        edges = [e for e in (0, 1, 111, 112, 239, 240, 943, width - 1, width)
                 if e <= width]
        lengths[:len(edges)] = edges
        lengths = torch.from_numpy(lengths).to(dev)
        pre = (zero[:, :prefix].expand(n, prefix) if hole
               else rand_bytes(rng, (n, prefix), dev))
        nw = 32 * sha512.nblocks_static(width + prefix)
        read = width + 4 + (0 if hole else prefix)
        rows.update(time_kernels(
            {name: (pack(sha512.pack_words), pack(sha512.pack_words_plain),
                    (msg, lengths, pre), NO_OPS, n * (read + 4 * nw + 4))},
            n, card, 5))
    return rows


def time_digits(dev, rng, card):
    """The digits kernel against its plain version (fold.cut8_bytes of S,
    fold.cut4_limbs(sc.from_digest(md))) at a token batch (262,144 lanes,
    the kernel table's B) and a packet batch (165,000), S read in place
    from 64-byte signature rows; the bound is its 480 bytes a lane (96 read,
    384 written) at the card's memory rate. Returns the two rows."""
    from curve25519_tpu_torch.ops import fold, sc
    from curve25519_tpu_torch.ops.cuda import verify_kernel as vk

    def plain(md, s):
        return fold.cut8_bytes(s), fold.cut4_limbs(sc.from_digest(md))

    rows = {}
    for name, n in (("digits_kernel", MAIN_BATCH),
                    ("digits_kernel.packets", 165_000)):
        md, sig = rand_bytes(rng, (n, 64), dev), rand_bytes(rng, (n, 64), dev)
        rows.update(time_kernels(
            {name: (vk.digits, plain, (md, sig[:, 32:]), NO_OPS,
                    n * (64 + 32 + 4 * (32 + 64)))}, n, card, 5))
    return rows


def time_limb_modes(cut8, cut4, card):
    """The base multiply's limb-mode kernels (basemult_fold8_limbs_kernel and
    basemult_fold4_limbs_kernel, the 13-bit lane; on no main path) in the
    "affine" mode at the main batch: one call after a warm-up, held
    byte-equal to one call of the plain version, beside the bound of the
    work. Returns their rows under basemult_kernel."""
    from curve25519_tpu_torch.ops.cuda import edwards_kernel as ek
    rows = {}
    for nfolds, cut in ((8, cut8), (4, cut4)):
        name = "basemult_fold%d_limbs_kernel" % nfolds
        ek.base_mult(cut[:8], mode="affine", nfolds=nfolds)
        kernel_s, got = timed_once(
            lambda c: ek.base_mult(c, mode="affine", nfolds=nfolds), cut)
        err = max_abs_err(got, ek.base_mult_plain(cut, mode="affine",
                                                  nfolds=nfolds))
        check(err == 0, "%s != plain at the main batch" % name)
        batch = len(cut)
        bms, by = bound_ms(bound.basemult_ops(nfolds), batch,
                           batch * (4 * cut.shape[-1] + 4 * 40))
        rows["basemult_kernel.fold%d_limbs" % nfolds] = {
            "max_abs_err": err, "ms": kernel_s * 1e3, "bound_ms": bms,
            "bound_by": by}
        print("phase 5 timing [%s]: %s (affine) B=%d kernel %.3f ms (one "
              "call after a warm-up) | bound %.3f ms (%s), %.1f%% | == plain"
              % (card, name, batch, kernel_s * 1e3, bms, by,
                 share(bms, kernel_s * 1e3, name)))
    return rows


def time_long_sha512(dev, card, lanes=LONG_SHA_LANES, length=1 << 20):
    """The long-message SHA-512 row in the reference's shape
    (benchmarks/bench_suite.py, sha512_long): 1,024 lanes of 1 MiB with
    lengths 0, 1, 111, L - 1, random and L, made on the card. The kernel on
    the packed words is held against hashlib on a few lanes and timed; the
    rate counts hashed bytes, the bound the active blocks."""
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
    bms, by = bound_ms((Counter(), bound.SHA_BLOCK_ALU), active,
                       active * 128 + lanes * (4 + 64))
    print("phase 5 timing [%s]: sha512_kernel long messages, %d lanes of "
          "%d bytes (lengths 0, 1, 111, L-1, random, L; %d bytes hashed, %d "
          "blocks): kernel %.3f ms (best of 3 x 2 after warm-up), %.2f GB/s "
          "of hashed bytes | pack_words %.3f ms (one call) | bound %.3f ms "
          "(%s), %.1f%% | == hashlib on 6 lanes"
          % (card, lanes, length, hashed, active, kernel_s * 1e3,
             hashed / kernel_s / 1e9, pack_s * 1e3, bms, by,
             share(bms, kernel_s * 1e3, "sha512_kernel, long messages")))


# ---------------------------------------------------------------------------
# Phase 6: verify
# ---------------------------------------------------------------------------
def verify_digits(sig, pk, msg):
    """(u, v): the fold digits of S and of h = SHA512(R || pk || m) mod l,
    by the digits kernel, as models/ed25519 computes them for the verify
    kernels."""
    from curve25519_tpu_torch.ops import sha512
    from curve25519_tpu_torch.ops.cuda import verify_kernel as vk
    prefix = torch.cat([sig[:, :32], pk.expand(sig.shape[0], 32)], -1)
    return vk.digits(sha512.sha512(msg, prefix=prefix), sig[:, 32:])


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
    ctx_half = ed25519.verify_init(pk[::2])       # the odd lanes' keys missed
    for label, launched, fn, args, expect in (
            ("verify_check", {"sha512_kernel": 1, "pack_words_kernel": 1,
                              "digits_kernel": 1, "poly_kernel": 1},
             ed25519.verify_check, (ctx, sig, msg), want),
            ("verify_check shared", {"sha512_kernel": 1,
                                     "pack_words_kernel": 1,
                                     "digits_kernel": 1,
                                     "poly_shared_kernel": 1},
             ed25519.verify_check, (ctx_one, sig_one, msg), want),
            ("verify", {"sha512_kernel": 1, "pack_words_kernel": 1,
                        "digits_kernel": 1, "oneshot_kernel": 1},
             ed25519.verify, (sig, pk, msg), want),
            ("verify_cached", {"sha512_kernel": 1, "pack_words_kernel": 1,
                               "digits_kernel": 1, "key_lookup_kernel": 1,
                               "poly_keyed_kernel": 1},
             ed25519.verify_cached, (ctx_half, sig, pk, msg), want)):
        got = path(label, launched, fn, *args)
        check(torch.equal(got, expect), "%s: %d of %d lanes wrong"
              % (label, int((got != expect).sum()), batch))
    print("phase 6 verify paths, B = %d distinct keys (launches): %s; every "
          "valid lane verifies, the %d tampered lanes do not"
          % (batch, "; ".join(lines), len(bad)))

    u, v = verify_digits(sig, pk, msg)
    u1, v1 = verify_digits(sig_one, pk[0], msg)
    # a vote batch's shape: each lane's key among VOTE_KEYS cached ones
    staked = ed25519.verify_init(pk[:VOTE_KEYS])
    voters = pk[torch.arange(batch, device=dev) % VOTE_KEYS]
    index = (voters, staked["pk"], vk.key_index(staked["pk"]))
    lookup = vk.key_lookup(*index)
    cases = {
        "verify_init_kernel": (vk.verify_init, vk.verify_init_plain, (pk,),
                               bound.verify_init_ops(),
                               batch * (32 + 2560 + 1)),
        "poly_kernel": (vk.poly_mult, vk.poly_mult_plain,
                        (u, v, ctx["planes"]), bound.poly_ops(),
                        batch * (128 + 256 + 2560 + 32)),
        "poly_shared_kernel": (vk.poly_mult, vk.poly_mult_plain,
                               (u1, v1, ctx_one["planes"]), bound.poly_ops(),
                               batch * (128 + 256 + 32) + 2560),
        "key_lookup_kernel": (
            lambda *a: vk.key_lookup(*a)[::2],       # the order's is free
            lambda *a: vk.key_lookup_plain(*a)[::2], index,
            (Counter(), 0), batch * (32 + 4 + 8) + VOTE_KEYS * (32 + 8 + 4)),
        "poly_keyed_kernel": (
            vk.poly_keyed,
            lambda u, v, lookup, *a: vk.poly_keyed_plain(u, v, lookup[0], *a),
            (u, v, lookup, staked["planes"], staked["ok"], voters),
            bound.poly_ops(),
            batch * (128 + 256 + 4 + 8 + 32 + 32 + 1) + VOTE_KEYS * 2560),
        "oneshot_kernel": (vk.verify_oneshot, vk.verify_oneshot_plain,
                           (pk, u, v), bound.verify_ops(0),
                           batch * (32 + 128 + 256 + 32 + 1)),
    }
    rows = time_kernels(cases, batch, card, 6)
    two = rows["verify_init_kernel"]["ms"] + rows["poly_kernel"]["ms"]
    print("phase 6 [%s]: oneshot_kernel %.3f ms against verify_init_kernel "
          "+ poly_kernel %.3f ms, B=%d (the fused kernel %s)"
          % (card, rows["oneshot_kernel"]["ms"], two, batch,
             "no slower" if rows["oneshot_kernel"]["ms"] <= two else "slower"))
    for label, fn, args in (
            ("verify_init", ed25519.verify_init, (pk,)),
            ("verify_check", ed25519.verify_check, (ctx, sig, msg)),
            ("verify_check shared", ed25519.verify_check,
             (ctx_one, sig_one, msg)),
            ("verify", ed25519.verify, (sig, pk, msg))):
        print("phase 6 profile [%s]: %s B=%d, 3 calls: %s"
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
# Phase 7: the rest of the single-device API
# ---------------------------------------------------------------------------
def phase_api(dev, rng, card, counts):
    lines = phase_ragged(dev, rng, card, counts)
    lines += phase_oo(dev, rng, card, counts)
    lines += phase_host_and_selftest(dev, rng)
    for line in lines:
        print("phase 7 " + line)


def phase_ragged(dev, rng, card, counts, n=RAGGED_MSGS):
    """sign_ragged and verify_ragged of n messages of 0-1,200 bytes (10
    SHA-512 block buckets), each call driven with the launch counts set to 0
    before it and read after: sign, sign blinded, verify, verify given a
    ctx, verify of one key's signatures. Their bytes and exact launches are
    held in tests/test_torch_cuda.py; here the verdicts are checked, and
    each call's warm rate, the host's bucket packing and a profile read."""
    from curve25519_tpu_torch.models import blinding, ed25519
    from curve25519_tpu_torch.utils import bucketing

    lengths = rng.integers(0, RAGGED_MAX + 1, n)
    flat = rng.bytes(int(lengths.sum()))
    ofs = np.concatenate([[0], np.cumsum(lengths)])
    msgs = [flat[ofs[i]:ofs[i + 1]] for i in range(n)]
    nbuckets = len(bucketing.bucket_indices(lengths))
    check(nbuckets == 10, "%d buckets, expected 10" % nbuckets)
    pk, priv = ed25519.create_keypair(rand_bytes(rng, (n, 32), dev))
    ctx_bl = blinding.blinding_init(b"chip-smoke ragged", device=dev)
    lines = []

    def path(label, fn, *args, **kw):
        out, wall, got = counts.drive(lambda: fn(*args, **kw))
        check(any(got.values()), "%s launched nothing" % label)
        # a second call, warm, for the rate
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args, **kw)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        lines.append("ragged %s: %d messages, host wall %.3f s (warm %.3f s, "
                     "%.0f messages/s) (%s)" % (
                         label, n, wall, warm, n / warm, ", ".join(
                             "%s %d" % kv for kv in sorted(got.items())
                             if kv[1])))
        return out

    sig = path("sign_ragged", ed25519.sign_ragged, priv, msgs)
    sig_bl = path("sign_ragged blinded", ed25519.sign_ragged, priv, msgs,
                  blinding=ctx_bl)
    check(torch.equal(sig_bl, sig), "the blinded ragged sign changed a "
          "signature")
    bad = [3, n // 3, n - 2]
    sig[bad[0], 0] ^= 1                           # R
    sig[bad[1], 40] ^= 1                          # S
    sig[bad[2]] = sig[bad[2] - 1]                 # another message's
    want = torch.ones(n, dtype=torch.bool, device=dev)
    want[bad] = False
    got = path("verify_ragged", ed25519.verify_ragged, sig, pk, msgs)
    check(torch.equal(got, want), "verify_ragged: %d of %d lanes wrong"
          % (int((got != want).sum()), n))
    ctx = ed25519.verify_init(pk)
    got = path("verify_ragged given a ctx", ed25519.verify_ragged, sig, None,
               msgs, ctx=ctx)
    check(torch.equal(got, want), "verify_ragged with a ctx: lanes wrong")
    sig1 = ed25519.sign_ragged(priv[0], msgs)
    sig1[bad[0], 63] ^= 1
    want[:] = True
    want[bad[0]] = False
    got = path("verify_ragged one key", ed25519.verify_ragged, sig1, pk[0],
               msgs)
    check(torch.equal(got, want), "verify_ragged of one key: lanes wrong")
    lines.append("ragged: %d buckets; the blinded sign unchanged; "
                 "verify_ragged true on every valid lane, false on the "
                 "tampered" % nbuckets)

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
    check(out["card"][5] == curve.sign(seed, msg),
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
    ell = curve.L
    xb = rand_bytes(rng, (SC_LANES, 32), dev)
    eb = rand_bytes(rng, (SC_LANES, 32), dev)
    x = sc.from_bytes(xb)
    xs = [int.from_bytes(row_bytes(r), "little") % ell for r in xb]
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
    want = {"inv": [pow(v, ell - 2, ell) for v in xs],
            "to_mont": [v * 2**256 % ell for v in xs],
            "mont_mul": [v * v * 2**256 % ell for v in xs],
            "from_mont": xs,
            "exp_mod_bpo": [pow(v, e, ell) for v, e in zip(xs, es)]}
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
# Phase 8: the multi-device path (parallel/mesh.py)
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
                     "pack_words_kernel": 3, "digits_kernel": 1,
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
        print("phase 8 mesh step: NCCL, world size 1 (%d card(s) seen), "
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
        print("phase 8 mesh timing [%s]: B = %d, step %.3f ms (%.1f "
              "protocol ops/s, best of 4 warm, host wall) | the seven calls "
              "without the mesh %.3f ms | step / calls %.4f"
              % (card, batch, step_s * 1e3, 2 * batch / step_s,
                 direct_s * 1e3, step_s / direct_s))
        print("phase 8 profile [%s]: mesh step B=%d, 3 calls: %s"
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
    print("phase 8 two gloo ranks on one card: B = %d, %s on each rank, "
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
        print("phase 8 example %s: exit 0 in %.1f s | %s"
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
    phase_card_tests()
    counts = Counts()
    rows = {"x25519_ladder_kernel": phase_x25519_main(dev, rng, card, counts)}
    rows.update(phase_ed_main(dev, rng, card, counts))
    rows.update(phase_verify_main(dev, rng, card, counts))
    phase_api(dev, rng, card, counts)
    phase_mesh(dev, rng, card, counts)
    check("jax" not in sys.modules and "curve25519_tpu" not in sys.modules,
          "the port imported jax or the JAX package")

    kernels = []
    for name, (src, replaces, entries) in KERNELS.items():
        row = rows[name]
        # the row and its other shapes (rows "<name>.<shape>")
        err = max(r["max_abs_err"] for k, r in rows.items()
                  if k == name or k.startswith(name + "."))
        check(counts.total[name] > 0, "%s was launched 0 times on the main "
              "paths" % name)
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "launches": counts.total[name],
            "max_abs_err": err, "ms": row["ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "registers": max(build_info[k]["registers"] for k in entries),
            "spill_store_bytes": max(build_info[k]["spill_store_bytes"]
                                     for k in entries),
            "stack_bytes": max(build_info[k]["stack_bytes"]
                               for k in entries),
        })
    print("chip_smoke wall time: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
