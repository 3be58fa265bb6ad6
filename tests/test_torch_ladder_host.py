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

The ladder, the verify kernels and the fold-4 byte modes run on another
core, ops/cuda/csrc/fe25519_wide.cuh (ten 32-bit limbs in radix 2^25.5),
the latter two through the Edwards formulas of csrc/edwards25519_wide.cuh.
Its checks are ``_check_wide_*`` helpers inside the tests below: an
executable interval proof of its limb bounds (in the manner of
tests/test_bounds.py) over one ladder step, the Verify_Init lane's ops, the
double-scalar multiply's lane (csrc/verify_lane.cuh, in poly.cu and
oneshot.cu) and the fold-4 base multiply's byte-mode lane
(csrc/basemult.cu), each of its ops through ``fe_wide_op_host`` against
Python integers mod p, and the RFC 7748 5.2 1,000-iteration vector through
``x25519_ladder_host``. None of them runs JAX.

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

# the WideOp enum of ladder.cu
WIDE_OPS = {"add": 0, "sub": 1, "mul": 2, "sqr": 3, "mul_small_add": 4,
            "select": 5, "canon": 6, "inv": 7, "to_bytes": 8,
            "from_bytes": 9, "neg": 10, "weak_carry": 11, "pow2523": 12,
            "is_zero": 13, "sqrt_ratio": 14, "to_limbs13": 15,
            "from_limbs13": 16, "mul_f64": 17, "to_f64": 18, "from_f64": 19}
# the row width of each wide op's output, where it is not 10 limbs
WIDE_OUT = {"to_bytes": 32, "is_zero": 1, "sqrt_ratio": 11,
            "to_limbs13": 20, "to_f64": 20}
# fe25519_wide.cuh: limb i holds W_WIDTH[i] bits from bit W_OFF[i]
W_WIDTH = [26 - (i & 1) for i in range(10)]
W_OFF = [26 * ((i + 1) // 2) + 25 * (i // 2) for i in range(11)]
# its stated invariants, as exclusive upper bounds per limb (all limbs >= 0)
W_TIGHT = [(1 << w) + (1 << 11 if i in (1, 5) else 0)
           for i, w in enumerate(W_WIDTH)]
W_LOOSE = [t + (2 << w) for t, w in zip(W_TIGHT, W_WIDTH)]

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
def lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    return build.load_host(build.build_host())


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
    _check_wide_ops(lib, rng, _WIDE_OF[names])


def test_inv_equals_twin_and_fe_tile(lib, rng, tmp_path):
    x = weak_limbs(rng, 4)
    got = host_op(lib, "inv", x)
    np.testing.assert_array_equal(got, fe.inv(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(got, untile(ft.t_inv(tile(x))))
    _check_concurrent_host_builds(tmp_path)
    _check_wide_core_bounds()
    _check_wide_ops(lib, rng, ("inv", "pow2523", "sqrt_ratio"))


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
    _check_wide_ops(lib, rng, ("from_bytes",))
    _check_wide_rfc7748_iterated(lib)


# ---------------------------------------------------------------------------
# The ladder's wide core (csrc/fe25519_wide.cuh)
# ---------------------------------------------------------------------------
# the wide ops checked beside each parametrized case of the 13-bit core
_WIDE_OF = {("add", "sub"): ("add", "sub"),
            ("neg", "mul_small_add"): ("mul_small_add", "select", "neg",
                                       "weak_carry"),
            ("mul", "sqr"): ("mul", "sqr", "mul_f64"),
            ("canon", "to_bytes"): ("canon", "to_bytes", "is_zero",
                                    "to_limbs13", "from_limbs13")}


def _u(lo, hi, bits):
    """An interval of unsigned values that must fit `bits` bits."""
    assert 0 <= lo <= hi < 1 << bits, (lo, hi, bits)
    return (lo, hi)


def _iadd(a, b, bits):
    return _u(a[0] + b[0], a[1] + b[1], bits)


def _imul(a, b, bits):
    return _u(a[0] * b[0], a[1] * b[1], bits)


def _ishr(a, s):
    return (a[0] >> s, a[1] >> s)


def _imask(a, w):
    """& (2^w - 1); tight when the interval stays in one 2^w window."""
    if a[0] >> w == a[1] >> w:
        return (a[0] & ((1 << w) - 1), a[1] & ((1 << w) - 1))
    return (0, (1 << w) - 1)


def _k(c):
    return (c, c)


def _w_add(x, y):
    return [_iadd(a, b, 32) for a, b in zip(x, y)]


def _w_sub(x, y):
    """x + 2p - y, left to right in uint32: must not wrap either way."""
    out = []
    for i, (a, b) in enumerate(zip(x, y)):
        two_p = (1 << 27) - 38 if i == 0 else (2 << W_WIDTH[i]) - 2
        t = _iadd(a, _k(two_p), 32)
        out.append(_u(t[0] - b[1], t[1] - b[0], 32))
    return out


def _w_carries(h, bits):
    """reduce_cols's twelve carries, in carry_order, on `bits`-bit limbs."""
    h = list(h)
    for i in (0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0):
        c = _ishr(h[i], W_WIDTH[i])
        h[i] = _imask(h[i], W_WIDTH[i])
        if i == 9:
            h[0] = _iadd(h[0], _imul(c, _k(19), bits), bits)
        else:
            h[i + 1] = _iadd(h[i + 1], c, bits)
    return [_u(*v, 32) for v in h]


def _w_reduce(h):
    """reduce_cols: the carries of 64-bit columns."""
    return _w_carries(h, 64)


def _w_weak_carry(x):
    """weak_carry: the same carries in 32 bits."""
    return _w_carries(x, 32)


def _w_neg(y):
    """2p - y in uint32 (sub from 0): must not wrap."""
    return _w_sub([_k(0)] * 10, y)


def _w_union(*vs):
    return [(min(v[0] for v in col), max(v[1] for v in col))
            for col in zip(*vs)]


def _w_mul(x, y):
    h = []
    for k in range(10):
        acc = (0, 0)
        for i in range(10):
            j = (k - i) % 10
            a = _imul(x[i], _k(2), 32) if i & j & 1 else x[i]
            b = _imul(y[j], _k(19), 32) if i > k else y[j]
            acc = _iadd(acc, _imul(a, b, 64), 64)
        h.append(acc)
    return _w_reduce(h)


def _w_sqr(x):
    h = [(0, 0)] * 10
    for i in range(10):
        for j in range(i, 10):
            wrap, odd, pair = i + j >= 10, bool(i & j & 1), i < j
            if not wrap:
                a = _imul(x[i], _k(2), 32) if pair or odd else x[i]
                b = _imul(x[j], _k(2), 32) if pair and odd else x[j]
            elif j & 1:
                a = _imul(x[i], _k(2), 32) if pair and odd else x[i]
                b = _imul(x[j], _k(38 if pair or odd else 19), 32)
            else:
                a = _imul(x[i], _k(2), 32) if pair else x[i]
                b = _imul(x[j], _k(19), 32)
            k = (i + j) % 10
            h[k] = _iadd(h[k], _imul(a, b, 64), 64)
    return _w_reduce(h)


def _w_msa(x, y):
    return _w_reduce([_iadd(_imul(_k(A24), b, 64), a, 64)
                      for a, b in zip(x, y)])


def _w_canon(x):
    """canon in uint32: one carry pass with the fold leaves V < 2p, so the
    q chain gives 0 or 1; the second pass and the mask give exact limbs."""
    h = list(x)

    def carry_seq():
        for i in range(9):
            h[i + 1] = _iadd(h[i + 1], _ishr(h[i], W_WIDTH[i]), 32)
            h[i] = _imask(h[i], W_WIDTH[i])

    carry_seq()
    h[0] = _iadd(h[0], _imul(_ishr(h[9], 25), _k(19), 32), 32)
    h[9] = _imask(h[9], 25)
    h[1] = _iadd(h[1], _ishr(h[0], 26), 32)
    h[0] = _imask(h[0], 26)
    assert sum(hi << W_OFF[i] for i, (_, hi) in enumerate(h)) < 2 * P
    q = _ishr(_iadd(h[0], _k(19), 32), 26)
    for i in range(1, 10):
        q = _ishr(_iadd(h[i], q, 32), W_WIDTH[i])
    assert q[1] <= 1
    h[0] = _iadd(h[0], _imul(q, _k(19), 32), 32)
    carry_seq()
    h[9] = _imask(h[9], 25)
    return h


def _within(v, bounds):
    return all(0 <= lo and hi < b for (lo, hi), b in zip(v, bounds))


def _w_sqr_times(x, n):
    for _ in range(n):
        x = _w_sqr(x)
    return x


def _w_chain_2_250(x):
    """chain_2_250: (x^(2^250 - 1), x^11)."""
    x2 = _w_sqr(x)
    x9 = _w_mul(_w_sqr(_w_sqr(x2)), x)
    x11 = _w_mul(x9, x2)
    x31 = _w_mul(_w_sqr(x11), x9)
    t = x10 = _w_mul(_w_sqr_times(x31, 5), x31)
    t = _w_mul(_w_sqr_times(t, 10), t)
    t = _w_mul(_w_sqr_times(t, 20), t)
    t = x50 = _w_mul(_w_sqr_times(t, 10), x10)
    t = _w_mul(_w_sqr_times(t, 50), t)
    t = _w_mul(_w_sqr_times(t, 100), t)
    return _w_mul(_w_sqr_times(t, 50), x50), x11


def _w_pow2523(x):
    """pow2523: chain_2_250, then two squarings and a multiply."""
    return _w_mul(_w_sqr_times(_w_chain_2_250(x)[0], 2), x)


def _w_inv(x):
    """inv: chain_2_250, then five squarings and a multiply by x^11."""
    t, x11 = _w_chain_2_250(x)
    return _w_mul(_w_sqr_times(t, 5), x11)


def _w_sqrt_ratio(u, v):
    """sqrt_ratio's ops in order; the checks' subtrahend must be TIGHT."""
    u = _w_weak_carry(u)
    assert _within(u, W_TIGHT), u
    v2 = _w_sqr(v)
    a = _w_mul(u, _w_mul(v2, v))
    b = _w_mul(a, _w_sqr(v2))
    x = _w_mul(_w_pow2523(b), a)
    _w_canon(_w_sub(_w_mul(_w_sqr(x), v), u))              # is_zero
    x = _w_union(x, _w_mul(x, _W_CONST))                   # select
    _w_canon(_w_sub(_w_mul(_w_sqr(x), v), u))
    return x


def _w_calculate_x(y):
    """calculate_x: the canonical root or its negation (select)."""
    y2 = _w_sqr(y)
    u = _w_sub(y2, _W_ONE)
    v = _w_add(_w_mul(y2, _W_CONST), _W_ONE)
    xc = _w_canon(_w_sqrt_ratio(u, v))
    return _w_union(xc, _w_neg(xc))


def _w_dbl(p):
    """ed_wide::dbl; every multiply's operands fit the proof of mul."""
    x, y, z, _ = p
    a, b, c = _w_sqr(x), _w_sqr(y), _w_sqr(z)
    c = _w_add(c, c)
    d = _w_neg(a)
    h = _w_weak_carry(_w_sub(d, b))
    g = _w_add(d, b)
    f = _w_weak_carry(_w_sub(g, c))         # c LOOSE: g's digits keep it >= 0
    e = _w_add(_w_sqr(_w_add(x, y)), h)
    return _w_mul(e, f), _w_mul(h, g), _w_mul(g, f), _w_mul(e, h)


def _w_add_pe(p, q):
    """ed_wide::add_pe; p = (ypx, ymx, t, z), q = (ypx, ymx, t2d, z2)."""
    a = _w_mul(p[1], q[1])
    b = _w_mul(p[0], q[0])
    c, d = _w_mul(p[2], q[2]), _w_mul(p[3], q[3])
    e, h, f, g = _w_sub(b, a), _w_add(b, a), _w_sub(d, c), _w_add(d, c)
    return _w_mul(e, f), _w_mul(h, g), _w_mul(g, f), _w_mul(e, h)


def _w_add_pa(p, q, carry_d=True):
    """ed_wide::add_pa; q = (ypx, ymx, t2d); carry_d=False drops the
    weak_carry of D = 2Z."""
    x, y, z, t = p
    a = _w_mul(_w_sub(y, x), q[1])
    b = _w_mul(_w_add(y, x), q[0])
    c = _w_mul(t, q[2])
    d = _w_add(z, z)
    if carry_d:
        d = _w_weak_carry(d)
    e, h, f, g = _w_sub(b, a), _w_add(b, a), _w_sub(d, c), _w_add(d, c)
    return _w_mul(e, f), _w_mul(h, g), _w_mul(g, f), _w_mul(e, h)


def _w_to_pe(p):
    """ed_wide::to_pe, then canon of each coordinate (the planes' store)."""
    x, y, z, t = p
    pe = (_w_add(y, x), _w_sub(y, x), _w_mul(t, _W_CONST), _w_add(z, z))
    return [_w_canon(c) for c in pe]


# a canonical constant (d, 2d, sqrt(-1), 1/2, 1/(2d)) and one, as limb
# intervals
_W_CONST = [(0, (1 << w) - 1) for w in W_WIDTH]
_W_ONE = [(1, 1)] + [(0, 0)] * 9


def _check_wide_edwards_bounds():
    """The Verify_Init lane of verify.cu on interval limbs: decode (y from
    from_bytes, x from calculate_x, the sqrt ratio and the pow2523 chain
    included), the start point's doubling and PE form, a doubling and to_pe
    on TIGHT state, and a subset-sum add of two entries read back through
    from_limbs13, the base's Z and T a product of its entry. Every output
    of a multiply is TIGHT, so the state stays TIGHT, and the stores' canon
    takes each coordinate below 2^width(i), which is what to_limbs13
    reads."""
    canonical = [(0, (1 << w) - 1) for w in W_WIDTH]
    tight = [(0, b - 1) for b in W_TIGHT]
    y = canonical                                           # from_bytes
    x = _w_calculate_x(y)
    below_2p = [hi + 1 for _, hi in _w_neg([_k(0)] * 10)]   # 2p's digits
    assert _within(x, below_2p), x
    start = (x, y, _W_ONE, _w_mul(x, y))
    state = (tight,) * 4
    entry = canonical                                       # from_limbs13
    for p in (start, state):
        for out in _w_dbl(p):
            assert _within(out, W_TIGHT), out
        for c in _w_to_pe(p):
            assert _within(c, [1 << w for w in W_WIDTH]), c
    z = t = _w_mul(entry, _W_CONST)                         # BaseEntry's
    for out in _w_add_pe((entry, entry, t, z), (entry,) * 4):
        assert _within(out, W_TIGHT), out
    # the ops on their own: neg of TIGHT stays below 2p digit by digit,
    # weak_carry takes limbs below 2^31 to TIGHT
    assert _within(_w_neg(tight), below_2p)
    assert _within(_w_weak_carry([(0, (1 << 31) - 1)] * 10), W_TIGHT)


def _w_gathered_coordinate():
    """A coordinate of a fold-8 entry as the tensor-core gather hands it to
    the lane (gather_mma.cuh): each word packed from four D values, each
    exactly one byte of the one-hot product (pack_word's shifts, whose bytes
    do not overlap), then from_words's masks: canonical digits, as fold 4's
    words give."""
    byte = _u(0, 255, 32)
    word = (0, 0)
    for k in range(4):
        word = _iadd(word, _imul(byte, _k(1 << 8 * k), 32), 32)
    return [_imask(word, w) for w in W_WIDTH]


def _check_wide_fold_bounds():
    """The fold lane of fold_wide.cuh on interval limbs, for fold 4's 64
    digits (the scan of word_table(4)) and fold 8's 32 (the tensor-core
    gather of word_table(8): basemult_fold8_kernel, keygen_kernel and
    sign_kernel): the lanes differ only in the digit count and in where an
    entry's words come from. The start point from a table entry's from_words
    (canonical digits) and a canonical zr (zr and BP arrive through
    from_bytes): x2 = ypx - ymx and y2 = ypx + ymx are LOOSE, T a product,
    and Z = 2zr goes LOOSE into dbl, which squares it only. A step, dbl then
    add_pa, on TIGHT state; add_pa needs the weak_carry of D = 2Z: without
    it 19 F, a multiply's pre-scaled operand, passes 32 bits. Every output of
    a step is TIGHT, so any number of steps stays inside the invariant. The
    BP add (add_pe with P read as (Y+X, Y-X, T, Z)) and the epilogues' one
    inversion and multiplies: u_bytes, and pk (ed_wide::pack, and pack_words
    of keygen and sign, the same field ops)."""
    canonical = [(0, (1 << w) - 1) for w in W_WIDTH]
    tight = [(0, b - 1) for b in W_TIGHT]
    zr = canonical
    for ncuts, entry in ((64, canonical), (32, _w_gathered_coordinate())):
        assert _within(entry, [1 << w for w in W_WIDTH]), ncuts
        x2, y2 = _w_sub(entry, entry), _w_add(entry, entry)
        start = (_w_mul(x2, zr), _w_mul(y2, zr), _w_add(zr, zr),
                 _w_mul(_w_mul(entry, _W_CONST), zr))
        state = (tight,) * 4
        for p in (start, state):
            for out in _w_dbl(p):
                assert _within(out, W_TIGHT), (ncuts, out)
        for out in _w_add_pa(state, (entry,) * 3):
            assert _within(out, W_TIGHT), (ncuts, out)
        with pytest.raises(AssertionError):
            _w_add_pa(state, (entry,) * 3, carry_d=False)
    x, y, z, t = state
    for out in _w_add_pe((_w_add(y, x), _w_sub(y, x), t, z), (canonical,) * 4):
        assert _within(out, W_TIGHT), out
    u = _w_mul(_w_add(z, y), _w_inv(_w_sub(z, y)))          # u_bytes
    zi = _w_inv(z)                                          # pk
    for out in (u, _w_mul(y, zi), _w_mul(x, zi)):
        assert _within(out, W_TIGHT), out
        assert _within(_w_canon(out), [1 << w for w in W_WIDTH]), out


def _w_poly_start(carry_x=True):
    """poly_lane's start from a q_table entry (from_limbs13: canonical
    digits): (weak_carry(ypx - ymx), weak_carry(ypx + ymx), z2, t2d / d);
    carry_x=False leaves X = ypx - ymx as it is."""
    entry = [(0, (1 << w) - 1) for w in W_WIDTH]
    x = _w_sub(entry, entry)
    if carry_x:
        x = _w_weak_carry(x)
    return (x, _w_weak_carry(_w_add(entry, entry)), entry,
            _w_mul(entry, _W_CONST))


def _check_wide_poly_bounds():
    """The double-scalar multiply's lane (verify_lane.cuh's poly_lane, in
    poly.cu and oneshot.cu) on interval limbs. The start from a q_table
    entry: X and Y are a difference and a sum of canonical limbs, which dbl
    does not take (its X + Y is squared, a LOOSE operand at most): both are
    carried to TIGHT, and without the carry of X the doubling's 32-bit
    pre-scaled operands overflow. One loop step on TIGHT state: dbl, the PA
    add of a word-table entry (from_words: canonical digits), the PE add of
    an entry read from the planes with P read as (Y+X, Y-X, T, Z). The
    epilogue: one inversion of Z and the multiplies of the pk encode. Every
    output of a step is TIGHT, so the 63 steps stay inside the invariant."""
    canonical = [(0, (1 << w) - 1) for w in W_WIDTH]
    tight = [(0, b - 1) for b in W_TIGHT]
    start = _w_poly_start()
    for c in start:
        assert _within(c, W_TIGHT), c
    for out in _w_dbl(start):
        assert _within(out, W_TIGHT), out
    with pytest.raises(AssertionError):
        _w_dbl(_w_poly_start(carry_x=False))
    state = (tight,) * 4
    for out in _w_add_pa(_w_dbl(state), (canonical,) * 3):
        assert _within(out, W_TIGHT), out
    x, y, z, t = state
    for out in _w_add_pe((_w_add(y, x), _w_sub(y, x), t, z),
                         (canonical,) * 4):
        assert _within(out, W_TIGHT), out
    zi = _w_inv(z)
    for out in (_w_mul(y, zi), _w_mul(x, zi)):
        assert _within(out, W_TIGHT), out
        assert _within(_w_canon(out), [1 << w for w in W_WIDTH]), out


# ---------------------------------------------------------------------------
# The ladder's FP64 multiply (csrc/fe25519_f64.cuh)
# ---------------------------------------------------------------------------
F_HALF = [1 << (w - 1) for w in W_WIDTH]
F_OFFSET = [19 << 27, (1 << 52) + (1 << 26)] + [1 << 52] * 8   # chain_offset
F_START = [0] + [F_OFFSET[k - 1] >> W_WIDTH[k - 1]              # col_start
                 for k in range(1, 10)] + [0] * 9
F_BIAS9 = 1 << 29                                  # kCol9Keep, less the start


def _f(v):
    """An FP64 value that must be an integer below 2^53 in magnitude: then
    it is exact, and so is the operation that gave it."""
    assert -(1 << 53) < v[0] <= v[1] < 1 << 53, v
    return v


def _f_fma(a, b, c):
    """dfma(a, b, c): the product and the sum, each below 2^53."""
    ps = [x * y for x in a for y in b]
    prod = _f((min(ps), max(ps)))
    return _f((prod[0] + c[0], prod[1] + c[1]))


def _f_cut(c, w, keep, floor):
    """The cut of column (or limb) c at width w: r = c + 1.5 * 2^(52 + w),
    rounded to nearest or toward minus infinity, keeps exponent 52 + w only
    for |c| < 2^(51 + w), so that it rounds c to a multiple q 2^w; then
    up = r - (magic + keep) = q 2^w - keep, a multiple of 2^w held exactly
    below 2^(53 + w), and c - up. Returns (q, c - up) as intervals."""
    assert -(1 << (51 + w)) <= c[0] and c[1] < 1 << (51 + w), (c, w)
    assert keep % (1 << w) == 0
    if floor:
        q = (c[0] >> w, c[1] >> w)
        lo, hi = 0, (1 << w) - 1
    else:                                          # ties either way
        h = 1 << (w - 1)
        q = (-((h - c[0]) >> w), (c[1] + h) >> w)
        lo, hi = -h, h
    if q[0] == q[1]:
        lo, hi = c[0] - (q[0] << w), c[1] - (q[0] << w)
    for up in (q[0] << w, q[1] << w):
        assert abs(up - keep) < 1 << (53 + w), (up, keep)
    return q, _f((lo + keep, hi + keep))


def _f_to_balanced(x, balanced=True):
    """to_balanced on interval limbs (uint32 ops as in the wide core's
    model), then the doubles y = 2^52 + v - (2^52 + 2^(w-1)) and 2y;
    balanced=False leaves out the 2^(w-1), which moves limbs in [0, 2^w]
    (one bit wider)."""
    half = F_HALF if balanced else [0] * 10
    t = [_iadd(a, _k(h), 32) for a, h in zip(x, half)]
    carry = [_ishr(v, w) for v, w in zip(t, W_WIDTH)]
    rest = [_imask(v, w) for v, w in zip(t, W_WIDTH)]
    v = [_iadd(r, c, 32) for r, c in
         zip(rest, [_imul(carry[9], _k(19), 32)] + carry[:9])]
    y = [_f((lo - h, hi - h)) for (lo, hi), h in zip(v, half)]
    return y, [_f((2 * lo, 2 * hi)) for lo, hi in y]


def _f_product_column(y, z, z2):
    """column(k, acc): acc plus column k's products, as fe_f64's column()
    (y times z, times z2 where both limbs are odd)."""
    def column(k, acc):
        for i in range(10):
            j = k - i
            if 0 <= j < 10:
                acc = _f_fma(y[i], z2[j] if i & j & 1 else z[j], acc)
        return acc
    return column


def _f_reduce(column, bias9=F_BIAS9):
    """The rest of fe_f64::mul on interval limbs, op by op: columns 18..10,
    each cut to the nearest multiple of 2^w and folded into columns 0..9;
    their own products; the cut of column 9; the floor chain 0..9, 0 and the
    move out (the low word of 2^52 + limb, so 0 <= limb < 2^32). Returns the
    limbs' intervals."""
    col = [_k(c) for c in F_START[:10]]
    for k in range(18, 9, -1):
        q, rest = _f_cut(column(k, _k(0)), W_WIDTH[k % 10], 0, floor=False)
        col[k - 10] = _f_fma(rest, _k(19), col[k - 10])
        col[k - 9] = _f((col[k - 9][0] + 19 * q[0], col[k - 9][1] + 19 * q[1]))
    for k in range(10):
        col[k] = column(k, col[k])
    keep9 = bias9 + F_START[9]
    q, col[9] = _f_cut(col[9], 25, keep9, floor=False)
    up9 = ((q[0] << 25) - keep9, (q[1] << 25) - keep9)  # a multiple of 2^25
    col[0] = _f((col[0][0] + 19 * (up9[0] >> 25),
                 col[0][1] + 19 * (up9[1] >> 25)))
    out = [None] * 10
    for k in range(10):
        q, out[k] = _f_cut(col[k], W_WIDTH[k], F_OFFSET[k], floor=True)
        t = ((q[0] << W_WIDTH[k]) - F_OFFSET[k],
             (q[1] << W_WIDTH[k]) - F_OFFSET[k])
        scale, dst = (1, k + 1) if k < 9 else (19, 0)
        into = col if k < 9 else out
        into[dst] = _f((into[dst][0] + scale * (t[0] >> W_WIDTH[k]),
                        into[dst][1] + scale * (t[1] >> W_WIDTH[k])))
    q, out[0] = _f_cut(out[0], 26, 1 << 52, floor=True)
    out[1] = _f((out[1][0] + q[0] - (1 << 26), out[1][1] + q[1] - (1 << 26)))
    limbs = [(lo - (1 << 52), hi - (1 << 52)) for lo, hi in out]
    for v in limbs:
        _u(*v, 32)                                  # the low word
    return limbs


def _f_mul(x, w, balanced=True, bias9=F_BIAS9):
    """fe_f64::mul: both moves in, then _f_reduce of the product's columns;
    balanced=False moves limbs one bit wider (unsigned)."""
    y, _ = _f_to_balanced(x, balanced)
    return _f_reduce(_f_product_column(y, *_f_to_balanced(w, balanced)),
                     bias9)


def _check_f64_mul_bounds():
    """The executable bounds proof of fe25519_f64.cuh. On LOOSE limbs (what
    the ladder multiplies) every move, product, column, partial sum, cut and
    carry is an integer below 2^53 (checked by _f as the model runs), each
    cut's sum keeps its exponent, and the limbs that come back are TIGHT;
    the model itself fails where it should: limbs moved one bit wider
    (unsigned, not balanced) pass 2^53 in the columns, and without column
    9's bias limb 1 can go below zero."""
    loose = [(0, b - 1) for b in W_LOOSE]
    y, _ = _f_to_balanced(loose)
    assert all(-h <= lo and hi <= h + 19 * 4 for (lo, hi), h in
               zip(y, F_HALF)), y
    out = _f_mul(loose, loose)
    assert _within(out, W_TIGHT), out
    assert out[1][1] <= 1 << 25, out
    with pytest.raises(AssertionError):
        _f_mul(loose, loose, balanced=False)
    with pytest.raises(AssertionError):
        _f_mul(loose, loose, bias9=0)


def _check_wide_core_bounds():
    """The executable bounds proof of fe25519_wide.cuh. Every 32-bit
    operand and sum and every 64-bit column, partial sum and carry of each
    op fits (checked by _u as the models run); sub never goes below zero;
    add and sub of TIGHT limbs are LOOSE; mul, sqr, mul_small_add and canon
    of LOOSE limbs are TIGHT (canon's exact), as are from_bytes and one.
    So any composition of the ladder's operations stays inside the stated
    invariant, and one ladder step on interval limbs shows it."""
    tight = [(0, b - 1) for b in W_TIGHT]
    loose = [(0, b - 1) for b in W_LOOSE]
    assert _within(tight, W_LOOSE)
    for out in (_w_add(tight, tight), _w_sub(tight, tight)):
        assert _within(out, W_LOOSE), out
    for out in (_w_mul(loose, loose), _w_sqr(loose), _w_msa(loose, loose),
                [(0, (1 << w) - 1) for w in W_WIDTH],       # from_bytes
                [(1, 1)] + [(0, 0)] * 9):                    # one
        assert _within(out, W_TIGHT), out
    assert _within(_w_canon(loose), [1 << w for w in W_WIDTH])
    # the stated slack of limbs 1 and 5 is needed: the carries reach it
    out = _w_mul(loose, loose)
    assert out[1][1] >= 1 << 25 and out[5][1] >= 1 << 25, out

    # one ladder step (ladder.cu), state and u TIGHT: cb, ax and bz on
    # fe25519_f64.cuh, the rest on this core
    x2 = z2 = x3 = z3 = u = tight
    a, bm = _w_add(x2, z2), _w_sub(x2, z2)
    c, d = _w_add(x3, z3), _w_sub(x3, z3)
    da, cb = _w_mul(d, a), _f_mul(c, bm)
    aa, bb = _w_sqr(a), _w_sqr(bm)
    e = _w_sub(aa, bb)
    for out in (_w_sqr(_w_add(da, cb)), _f_mul(u, _w_sqr(_w_sub(da, cb))),
                _f_mul(aa, bb), _w_mul(e, _w_msa(aa, e))):
        assert _within(out, W_TIGHT), out
    _check_f64_mul_bounds()
    _check_wide_edwards_bounds()
    _check_wide_fold_bounds()
    _check_wide_poly_bounds()


def _w_value(limbs):
    return sum(int(v) << W_OFF[i] for i, v in enumerate(limbs))


def _w_limbs(value):
    return [(value >> W_OFF[i]) & ((1 << w) - 1) for i, w in enumerate(W_WIDTH)]


def _w_inputs(rng, bounds, n):
    """n random limb rows below `bounds`, then the extremes: every limb at
    its bound - 1, zero, and the canonical limbs of 1, p - 1 and 2^255 - 1
    (which is >= p)."""
    rand = np.stack([rng.integers(0, b, n, dtype=np.int64) for b in bounds],
                    axis=1)
    extreme = [[b - 1 for b in bounds], [0] * 10, _w_limbs(1),
               _w_limbs(P - 1), _w_limbs(2**255 - 1)]
    return np.concatenate([rand, np.array(extreme, np.int64)]).astype(
        np.uint32)


def wide_op(lib, name, x, y=None):
    x = np.ascontiguousarray(x)
    y = None if y is None else np.ascontiguousarray(y, np.uint32)
    out = np.zeros((len(x), WIDE_OUT.get(name, 10)),
                   {"to_bytes": np.uint8, "to_f64": np.float64}.get(
                       name, np.uint32))
    rc = lib.fe_wide_op_host(WIDE_OPS[name], out.ctypes.data, x.ctypes.data,
                             None if y is None else y.ctypes.data, len(x))
    assert rc == 0
    return out


def _limbs13(value):
    return [(value >> 13 * k) & 0x1FFF for k in range(20)]


def _sqrt_ratio_int(u, v):
    """fe25519::sqrt_ratio on Python integers: (x mod p, ok)."""
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    good = (x * x * v - u) % P == 0
    if not good:
        x = x * pow(2, (P - 1) // 4, P) % P
    return x, good or (x * x * v - u) % P == 0


def _check_wide_conversions(lib, rng):
    """to_limbs13 of canonical limbs and from_limbs13 of 13-bit canonical
    limbs against the values' own digits, p - 1, 0 and 1 included."""
    values = [int(v) for v in rng.integers(0, 2**63, 40)] + [
        int.from_bytes(rng.bytes(32), "little") % P for _ in range(40)] + [
        0, 1, P - 1, 2**254]
    canon_rows = np.array([_w_limbs(v) for v in values], np.uint32)
    got = wide_op(lib, "to_limbs13", canon_rows)
    np.testing.assert_array_equal(got, [_limbs13(v) for v in values])
    back = wide_op(lib, "from_limbs13", got.view(np.int32))
    np.testing.assert_array_equal(back, canon_rows)


def _check_wide_ops(lib, rng, names):
    """Each named op of the wide core through fe_wide_op_host against
    Python integers mod p, on random limbs and the invariant's extremes;
    outputs must also lie inside the invariant the proof states."""
    canon_bounds = [1 << w for w in W_WIDTH]
    below_2p = [(2 << w) - 1 for w in W_WIDTH]     # 2p's digits, + 1
    below_2p[0] = (1 << 27) - 37
    for name in names:
        if name == "from_bytes":
            b = rng.integers(0, 256, (40, 32), dtype=np.uint8)
            b[:8, 31] |= 0x80                     # bit 255 is not read
            b[8] = 0xFF                           # 2^256 - 1 -> 2^255 - 1
            got = wide_op(lib, name, b)
            for row, want in zip(got, b):
                v = int.from_bytes(want.tobytes(), "little") % 2**255
                assert _w_value(row) == v and _within(
                    [(int(t), int(t)) for t in row], canon_bounds), name
            continue
        if name in ("to_limbs13", "from_limbs13"):
            _check_wide_conversions(lib, rng)
            continue
        if name == "mul_f64":
            _check_f64_mul(lib, rng)
            continue
        ins = {"add": W_TIGHT, "sub": W_TIGHT, "neg": W_TIGHT,
               "weak_carry": [1 << 31] * 10}.get(name, W_LOOSE)
        x = _w_inputs(rng, ins, 4 if name in ("inv", "pow2523") else 40)
        y = _w_inputs(rng, ins, len(x) - 5)[::-1].copy()
        if name == "is_zero":                     # 0 as 0, p and 2p
            zeros = np.array([[0] * 10, _w_limbs(P),
                              [b - 1 for b in below_2p]], np.uint32)
            x, y = np.concatenate([x, zeros]), np.concatenate([y, zeros])
        if name == "sqrt_ratio":                  # v = 0; u/v = v^2
            y[1] = 0
            vy = _w_value(y[2]) % P
            x[2] = _w_limbs(pow(vy, 3, P))
        got = wide_op(lib, name, x, y)
        for lane, (row, a, b) in enumerate(zip(got, x, y)):
            va, vb = _w_value(a), _w_value(b)
            if name == "to_bytes":
                assert row.tobytes() == (va % P).to_bytes(32, "little"), name
                continue
            if name == "is_zero":
                assert row[0] == (va % P == 0), (name, lane)
                assert lane < len(x) - 3 or row[0] == 1, lane
                continue
            if name == "sqrt_ratio":
                want_x, want_ok = _sqrt_ratio_int(va % P, vb % P)
                assert (_w_value(row[:10]) % P, bool(row[10])) == (
                    want_x, want_ok), (name, lane)
                assert _within([(int(t), int(t)) for t in row[:10]],
                               W_TIGHT), (name, lane)
                if lane in (1, 2):
                    assert want_ok == (lane == 2 or va % P == 0), lane
                continue
            want, bound = {
                "add": (va + vb, W_LOOSE), "sub": (va - vb, W_LOOSE),
                "mul": (va * vb, W_TIGHT), "sqr": (va * va, W_TIGHT),
                "mul_small_add": (va + A24 * vb, W_TIGHT),
                "select": (va if lane & 1 else vb, W_LOOSE),
                "canon": (va, canon_bounds),
                "inv": (pow(va, P - 2, P), W_TIGHT),
                "neg": (-va, below_2p),
                "weak_carry": (va, W_TIGHT),
                "pow2523": (pow(va, (P - 5) // 8, P), W_TIGHT),
            }[name]
            value = _w_value(row)
            assert value % P == want % P, (name, lane)
            assert _within([(int(t), int(t)) for t in row], bound), (name,
                                                                     lane)
            if name == "canon":
                assert value == va % P
            if name == "select":
                np.testing.assert_array_equal(row, a if lane & 1 else b)


def _check_f64_mul(lib, rng):
    """fe_f64::mul and its moves through fe_wide_op_host (g++, IEEE
    doubles), on random LOOSE rows and the extremes of _w_inputs (every limb
    at its LOOSE bound, zero, and the canonical limbs of 1, p - 1 and
    2^255 - 1, each squared), against fe_wide::mul and
    Python integers. The products are TIGHT and equal fe_wide::mul's limb
    for limb, except where x y lies within 2^26 of a multiple of p: there
    both are TIGHT limbs of the same field element, which may differ by p,
    and their canonical limbs are equal. The move in gives balanced limbs of
    x's value (|y_i| at most 2^(w-1) + 76), and 2y; the move out reads limb
    v from the double 2^52 + v."""
    x = _w_inputs(rng, W_LOOSE, 40)
    y = _w_inputs(rng, W_LOOSE, 40)       # the same extremes: squared
    got, want = wide_op(lib, "mul_f64", x, y), wide_op(lib, "mul", x, y)
    for lane, (row, ref, a, b) in enumerate(zip(got, want, x, y)):
        prod = _w_value(a) * _w_value(b) % P
        assert _within([(int(t), int(t)) for t in row], W_TIGHT), lane
        assert _w_value(row) % P == prod, lane
        if min(prod, P - prod) < 1 << 26:
            assert lane >= len(x) - 5, lane           # among the extremes
            continue
        np.testing.assert_array_equal(row, ref, err_msg=str(lane))
    np.testing.assert_array_equal(wide_op(lib, "canon", got),
                                  wide_op(lib, "canon", want))
    moved = wide_op(lib, "to_f64", x)
    for lane, (row, a) in enumerate(zip(moved, x)):
        v = [int(t) for t in row[:10]]
        assert row[:10].tolist() == v and row[10:].tolist() == [2 * t for t in v]
        assert sum(t << W_OFF[i] for i, t in enumerate(v)) % P == \
            _w_value(a) % P, lane
        assert all(abs(t) <= h + 76 for t, h in zip(v, F_HALF)), (lane, v)
    limbs = np.concatenate([x[:, :10], [[0] * 10, [(1 << 32) - 1] * 10]])
    held = limbs.astype(np.float64) + 2.0**52
    np.testing.assert_array_equal(wide_op(lib, "from_f64", held), limbs)


def _check_wide_rfc7748_iterated(lib):
    """RFC 7748 5.2: k = u = 9, then k, u = X25519(k, u), k; after 1 and
    after 1,000 iterations, through x25519_ladder_host."""
    k = u = bytes([9]) + bytes(31)
    for i in range(1000):
        kc = codec.clamp(torch.frombuffer(bytearray(k), dtype=torch.uint8))
        out = host_ladder(lib, np.frombuffer(u, np.uint8)[None],
                          kc.numpy()[None])
        k, u = out[0].tobytes(), k
        if i == 0:
            assert k.hex() == ("422c8e7a6227d7bca1350b3e2bb7279f"
                               "7897b87bb6854b783c60e80311ae3079")
    assert k.hex() == ("684cf59ba83309552800ef566f2f4d3c"
                       "1c3887c49360e3875f2eb94d99532c51")


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
    _check_ladder_products(lib)
    # the host core's ladder (native/ref25519.cpp) on the same lanes
    assert [bindings.x25519(bytes(a), bytes(b)) for a, b in zip(k, u)] == [
        bytes(r) for r in got]
    _check_host_core_equals_jax(rng)


def _check_ladder_products(lib):
    """x25519_ladder_products, the per-lane counts that the wrapper adds to
    ladder_kernel.pipe_products, against the lane's operations: on the FP64
    pipe 100 products for each of a step's three multiplies there; on
    IMAD.WIDE 100 for each other multiply (2 a step, 3 at the start, the
    last one, 11 in the inversion), 55 for each squaring (4 a step, 2 at the
    start, 254 in the inversion) and 10 for each a24 multiply-add (one a
    step, one at the start)."""
    counts = np.zeros(2, np.int64)
    assert lib.x25519_ladder_products(counts.ctypes.data) == 0
    steps = 254
    assert counts.tolist() == [
        3 * steps * 100,
        (2 * steps + 3 + 1 + 11) * 100 + (4 * steps + 2 + 254) * 55
        + (steps + 1) * 10]


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
