"""The CUDA kernel's arithmetic, built for the CPU with g++.

ops/cuda/csrc/fe25519.cuh and the per-lane ladder of ladder.cu are
``__host__ __device__`` code; build.build_host compiles them with g++ into a
library whose host entries run the same per-lane code on the CPU. Here that
code is held, exactly, against:

- the port's plain field core (curve25519_tpu_torch.ops.fe), limb for limb;
- the TPU kernel's field core (curve25519_tpu.ops.pallas.fe_tile and
  sc_tile.limbs_from_byte_rows), run eagerly on [20, 1, B] tiles, limb for
  limb;
- the plain ladder (models/montgomery.point_multiply) and the Python oracle
  (curve25519_tpu.refmodel), byte for byte.

The port's host core (curve25519_tpu_torch/native, a byte-equal copy of the
JAX package's ref25519.cpp built with g++) is held against the JAX
package's build of the same source through both packages' bindings.
Processes that build the host library into one directory at once share
build.py's lock: one compiles, all load its library, and each gets the
compiler's error text whole.
"""

import fcntl
import functools
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curve25519_tpu import refmodel
from curve25519_tpu.config import A24, P
from curve25519_tpu.ops import fe as jfe
from curve25519_tpu.ops.pallas import fe_tile as ft
from curve25519_tpu.ops.pallas import sc_tile as sct

from curve25519_tpu_torch.config import int_to_limbs
from curve25519_tpu_torch.models import montgomery
from curve25519_tpu_torch.ops import codec, fe
from curve25519_tpu_torch.native import bindings
from curve25519_tpu_torch.oo import X25519Private
from curve25519_tpu_torch.ops.cuda import build
from curve25519_tpu_torch.ops.sha512 import Sha512

# the FeOp enum of ladder.cu
OPS = {"add": 0, "sub": 1, "neg": 2, "mul": 3, "sqr": 4, "mul_small_add": 5,
       "canon": 6, "inv": 7, "to_bytes": 8, "from_bytes": 9}

EDGE_U = [0, 1, P, P + 1, 2**255 - 1, 1 | 1 << 255]

REPO = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def jax_host_core():
    """The JAX package's host core (curve25519_tpu.native.bindings), built
    once under a lock: its build writes the library in place, so two test
    processes must not race."""
    from curve25519_tpu.native import bindings as jbindings
    lock = Path(tempfile.gettempdir()) / "curve25519_tpu_native.lock"
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        jbindings.load()
    return jbindings


@pytest.fixture(scope="module", autouse=True)
def _free_xla_executables():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    return build.load_host(build.build_host(tmp_path_factory.mktemp("host")))


@pytest.fixture
def rng():
    return np.random.default_rng(25519)


def weak_limbs(rng, n):
    lo, hi = jfe.WEAK_MIN, jfe.WEAK_MAX
    rand = rng.integers(lo, hi + 1, (n, 20)).astype(np.int32)
    extreme = np.stack([np.full(20, lo), np.full(20, hi),
                        int_to_limbs(P - 1), int_to_limbs(0)])
    return np.concatenate([rand, extreme.astype(np.int32)])


def host_op(lib, name, x, y=None):
    x = np.ascontiguousarray(x, np.int32)
    y = None if y is None else np.ascontiguousarray(y, np.int32)
    out = np.zeros((len(x), 32 if name == "to_bytes" else 20), np.int32)
    rc = lib.fe25519_op_host(OPS[name], out.ctypes.data, x.ctypes.data,
                             None if y is None else y.ctypes.data, len(x))
    assert rc == 0
    return out


def host_ladder(lib, u, k, zr=None):
    """u, k: [n, 32] uint8 (k clamped); zr: [n, 20] int32 or None."""
    u, k = np.ascontiguousarray(u), np.ascontiguousarray(k)
    zr = None if zr is None else np.ascontiguousarray(zr, np.int32)
    out = np.zeros_like(u)
    lib.x25519_ladder_host(out.ctypes.data, u.ctypes.data, k.ctypes.data,
                           None if zr is None else zr.ctypes.data, len(u))
    return out


def tile(x):
    """[B, K] -> [K, 1, B], the fe_tile layout with one sublane."""
    return jnp.asarray(np.ascontiguousarray(x.T[:, None, :]))


def untile(t):
    return np.asarray(t)[:, 0, :].T


_TWIN = {
    "add": (lambda x, y: fe.add(x, y), lambda x, y: ft.t_add(x, y)),
    "sub": (lambda x, y: fe.sub(x, y), lambda x, y: ft.t_sub(x, y, ft.t_pad())),
    "neg": (lambda x, y: fe.neg(x), lambda x, y: ft.t_neg(x, ft.t_pad())),
    "mul": (lambda x, y: fe.mul(x, y), lambda x, y: ft.t_mul(x, y)),
    "sqr": (lambda x, y: fe.sqr(x), lambda x, y: ft.t_sqr(x)),
    "mul_small_add": (lambda x, y: fe.mul_small_add(x, A24, y),
                      lambda x, y: ft.t_mul_small_add(x, A24, y)),
    "canon": (lambda x, y: fe.canon(x), lambda x, y: ft.t_canon(x)),
    "to_bytes": (lambda x, y: fe.to_bytes(x).to(torch.int32),
                 lambda x, y: ft.t_to_bytes(x)),
}


@pytest.mark.parametrize("names", [("add", "sub"), ("neg", "mul_small_add"),
                                   ("mul", "sqr"), ("canon", "to_bytes")],
                         ids="-".join)
def test_field_ops_equal_twin_and_fe_tile(lib, rng, names):
    x, y = weak_limbs(rng, 48), weak_limbs(rng, 48)[::-1].copy()
    for name in names:
        got = host_op(lib, name, x, y)
        torch_fn, tile_fn = _TWIN[name]
        twin = torch_fn(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        np.testing.assert_array_equal(got, twin, err_msg=name)
        np.testing.assert_array_equal(got, untile(tile_fn(tile(x), tile(y))),
                                      err_msg=name)


def test_inv_equals_twin_and_fe_tile(lib, rng, tmp_path):
    x = weak_limbs(rng, 4)
    got = host_op(lib, "inv", x)
    np.testing.assert_array_equal(got, fe.inv(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(got, untile(ft.t_inv(tile(x))))
    _check_concurrent_host_builds(tmp_path)


# builds the host library into argv[1] with argv[2:] added to g++'s flags;
# prints {"ino", "mtime_ns", "pk"} (pk: the ladder of key 0..31 from u = 9)
# or {"error": the RuntimeError's text}
_BUILD_CHILD = """
import json, os, sys
import numpy as np
from curve25519_tpu_torch.ops.cuda import build
build.GXX_FLAGS = build.GXX_FLAGS + sys.argv[2:]
try:
    so = build.build_host(sys.argv[1])
except RuntimeError as e:
    print(json.dumps({"error": str(e)}))
    sys.exit(0)
lib = build.load_host(so)
k = np.arange(32, dtype=np.uint8)
k[0] &= 248
k[31] = (k[31] & 127) | 64
u = np.zeros(32, np.uint8)
u[0] = 9
out = np.zeros(32, np.uint8)
lib.x25519_ladder_host(out.ctypes.data, u.ctypes.data, k.ctypes.data,
                       None, 1)
st = os.stat(so)
print(json.dumps({"ino": st.st_ino, "mtime_ns": st.st_mtime_ns,
                  "pk": out.tobytes().hex()}))
"""


def _check_concurrent_host_builds(tmp_path):
    """Four processes start at once: two build the host library into one
    fresh directory, two more a build that g++ refuses into another. The
    first two load one build (the same file) and its ladder gives the
    oracle's bytes; the other two each raise with g++'s whole error text,
    which is what the log holds."""
    bogus = "-fno-such-option-for-the-lock-check"
    runs = [(tmp_path / "good", [])] * 2 + [(tmp_path / "bad", [bogus])] * 2
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, str(d),
                               *flags], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for d, flags in runs]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    res = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    pk = refmodel.x25519(bytes(range(32)), bytes([9]) + bytes(31)).hex()
    assert [r["pk"] for r in res[:2]] == [pk, pk]
    assert res[0]["ino"] == res[1]["ino"]
    assert res[0]["mtime_ns"] == res[1]["mtime_ns"]      # built once
    log = (tmp_path / "bad" / "libport_host.log").read_text()
    assert log.count(bogus) == 1, log
    for r in res[2:]:
        assert r["error"].startswith("g++ failed"), r
        assert r["error"].split(":\n", 1)[1] == log


def test_from_bytes_equals_twin_and_sc_tile(lib, rng):
    b = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    b[-1] = 0xFF
    got = host_op(lib, "from_bytes", b.astype(np.int32))
    np.testing.assert_array_equal(got, fe.from_bytes(torch.from_numpy(b)).numpy())
    rows = tile(b.astype(np.int32))
    np.testing.assert_array_equal(got, untile(sct.limbs_from_byte_rows(rows)))


def test_host_ladder_equals_plain(lib, rng):
    u = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    k = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    u[0] = 0                                       # all-zero peer
    u[1, 31] |= 0x80                               # bit 255 set: masked
    k_cl = codec.clamp(torch.from_numpy(k)).numpy()
    got = host_ladder(lib, u, k_cl)
    want = montgomery.point_multiply(torch.from_numpy(u), torch.from_numpy(k))
    np.testing.assert_array_equal(got, want.numpy())
    assert not got[0].any()
    # the host core's ladder (native/ref25519.cpp) on the same lanes
    assert [bindings.x25519(bytes(a), bytes(b)) for a, b in zip(k, u)] == [
        bytes(r) for r in got]
    _check_host_core_equals_jax(rng)


def _check_host_core_equals_jax(rng):
    """The port's copy of ref25519.cpp is the JAX package's, byte for byte,
    and its bindings give the JAX bindings' bytes on every entry."""
    assert (REPO / "curve25519_tpu_torch/native/ref25519.cpp").read_bytes() \
        == (REPO / "curve25519_tpu/native/ref25519.cpp").read_bytes()
    jnative = jax_host_core()
    for n in (0, 1, 64, 200):
        sk, peer = rng.bytes(32), rng.bytes(32)
        msg = rng.bytes(n)
        assert bindings.x25519(sk, peer) == jnative.x25519(sk, peer)
        assert bindings.x25519_base(sk) == jnative.x25519_base(sk) == \
            bindings.x25519_base_fast(sk) == jnative.x25519_base_fast(sk)
        pk, priv = bindings.ed25519_keypair(sk)
        assert (pk, priv) == jnative.ed25519_keypair(sk) == \
            bindings.ed25519_keypair_fast(sk)
        sig = bindings.ed25519_sign(priv, msg)
        assert sig == jnative.ed25519_sign(priv, msg) == \
            bindings.ed25519_sign_fast(priv, msg)
        assert bindings.ed25519_verify(sig, pk, msg)
        bad = bytes([sig[0] ^ 1]) + sig[1:]
        assert bindings.ed25519_verify(bad, pk, msg) == \
            jnative.ed25519_verify(bad, pk, msg) is False
        assert bindings.sha512(msg) == jnative.sha512(msg) == \
            hashlib.sha512(msg).digest()
        s, js = bindings.Sha512Stream(), jnative.Sha512Stream()
        for part in (msg[:n // 3], msg[n // 3:]):
            s.update(part)
            js.update(part)
        assert s.final() == js.final()
    with pytest.raises(ValueError):
        bindings.x25519(sk[:31], peer)


def test_host_ladder_edge_u_and_zr_match_oracle(lib, rng, monkeypatch,
                                                tmp_path):
    n = len(EDGE_U)
    u = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                  for v in EDGE_U])
    k = codec.clamp(torch.full((n, 32), 7, dtype=torch.uint8)).numpy()
    zr = np.stack([int_to_limbs(int.from_bytes(rng.bytes(32), "little") % P
                                or 1) for _ in range(n)])
    got = host_ladder(lib, u, k)
    np.testing.assert_array_equal(host_ladder(lib, u, k, zr), got)
    for row, v in zip(got, EDGE_U):
        assert row.tobytes() == refmodel.x25519(b"\x07" * 32,
                                                v.to_bytes(32, "little"))
    _check_host_core_build_failure_raises(monkeypatch, tmp_path)


def _check_host_core_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: without g++ the host core and every route on it raise."""
    monkeypatch.setattr(bindings, "_SO", tmp_path / "lib.so")
    monkeypatch.setattr(bindings.shutil, "which", lambda name: None)
    bindings.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            Sha512()
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            X25519Private(b"\1" * 32, native=True)
    finally:
        monkeypatch.undo()
        bindings.load.cache_clear()
