"""The port's mod-l scalar arithmetic and fold digits against the JAX
package's, limb for limb, and the g++ build of the kernels' mod-l code
(csrc/sc25519.cuh) and of verify's digits kernel (csrc/digits.cu) against
the port's plain ops/sc.py and ops/fold.py.

Both packages use 20 limbs of 13 bits and the same integer steps, so limbs
must be equal, not only equal mod l. The selftest ops (inv, the Montgomery
forms and exp_mod_bpo) run on 4 lanes on both sides (the JAX ones eagerly,
inv and exp_mod_bpo each compile one scan) and against Python integers.
Inputs come from a seeded numpy generator plus the boundary values of
tests/test_sc.py. Tolerance: exact.
"""

import functools
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curve25519_tpu.config import ELL, int_to_limbs
from curve25519_tpu.ops import fold as jfold
from curve25519_tpu.ops import sc as jsc

from curve25519_tpu_torch.config import limbs_to_int
from curve25519_tpu_torch.ops import fold, sc
from curve25519_tpu_torch.ops.cuda import build
from curve25519_tpu_torch.utils import interop
from curve25519_tpu_torch.utils.interop import to_numpy

# the carriers default to the card: these tests ask for the CPU
from_numpy = functools.partial(interop.from_numpy, device="cpu")

EDGE = [0, 1, 2, ELL - 1, ELL - 2, ELL // 2, 2**252, 2**252 - 1]

# the ScOp enum of sign.cu
OPS = {"mod": 0, "add": 1, "mul": 2, "muladd": 3, "sub_from_ell": 4,
       "from_digest": 5, "cut8": 6}


@pytest.fixture(scope="module", autouse=True)
def _free_xla_executables():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(252)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    return build.load_host(build.build_host())


def canonical(rng, n):
    """n random canonical scalars and the edge values, as limbs."""
    vals = [int.from_bytes(rng.bytes(32), "little") % ELL for _ in range(n)]
    return np.stack([int_to_limbs(v) for v in vals + EDGE])


def raw(rng, n):
    """Normalized limbs of arbitrary 256-bit values (inputs of mod)."""
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    vals += [2**256 - 1, ELL, 2 * ELL, 0]
    return np.stack([int_to_limbs(v) for v in vals])


_OPS = {
    "mod": (lambda x, y, z, d: sc.mod(x), lambda x, y, z, d: jsc.mod(x)),
    "add": (lambda x, y, z, d: sc.add(x, y), lambda x, y, z, d: jsc.add(x, y)),
    "sub_from_ell": (lambda x, y, z, d: sc.sub_from_ell(x),
                     lambda x, y, z, d: jsc.sub_from_ell(x)),
    "mul": (lambda x, y, z, d: sc.mul(x, y), lambda x, y, z, d: jsc.mul(x, y)),
    "muladd": (lambda x, y, z, d: sc.muladd(x, y, z),
               lambda x, y, z, d: jsc.muladd(x, y, z)),
    "from_digest": (lambda x, y, z, d: sc.from_digest(d),
                    lambda x, y, z, d: jsc.from_digest(d)),
    "from_bytes": (lambda x, y, z, d: sc.from_bytes(d[..., :32]),
                   lambda x, y, z, d: jsc.from_bytes(d[..., :32])),
    "to_bytes": (lambda x, y, z, d: sc.to_bytes(x),
                 lambda x, y, z, d: jsc.to_bytes(x)),
}


def _inputs(rng):
    x = canonical(rng, 24)
    y, z = x[::-1].copy(), np.roll(x, 3, 0)
    d = rng.integers(0, 256, (len(x), 64), dtype=np.uint8)
    d[0], d[1] = 0, 255
    return x, y, z, d


@pytest.mark.parametrize("names", [("mod", "add", "sub_from_ell"),
                                   ("mul", "muladd"),
                                   ("from_digest", "from_bytes", "to_bytes")],
                         ids="-".join)
def test_sc_ops_limbs_equal_jax(rng, names):
    x, y, z, d = _inputs(rng)
    if names[0] == "mod":
        x = raw(rng, len(x) - 4)
    for name in names:
        port, ref = _OPS[name]
        got = port(*(from_numpy(a) for a in (x, y, z, d)))
        want = ref(*(jnp.asarray(a) for a in (x, y, z, d)))
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want),
                                      err_msg=name)


def test_sc_results_are_canonical_and_right(rng):
    x, y, z, _ = _inputs(rng)
    xs, ys, zs = ([limbs_to_int(r) for r in a] for a in (x, y, z))
    got = to_numpy(sc.muladd(from_numpy(x), from_numpy(y), from_numpy(z)))
    assert [limbs_to_int(r) for r in got] == [
        (a * b + c) % ELL for a, b, c in zip(xs, ys, zs)]
    assert got.min() >= 0 and got.max() < 2**13
    _check_selftest_ops_equal_jax_and_integers(rng)
    _check_below_l(rng)


def _check_below_l(rng):
    """below_l (the strict verdict's S < l) against Python integers and the
    canonical round trip it replaced, at l's edges and at random."""
    vals = [0, 1, ELL - 1, ELL, ELL + 1, 2 * ELL - 1, 2**252 - 1, 2**252,
            2**252 + 1, 2**253, 2**256 - 1, ELL ^ 1, ELL ^ (1 << 128),
            ELL - (1 << 200)]
    vals += [int.from_bytes(rng.bytes(32), "little") % (k * ELL)
             for k in (1, 2, 16) for _ in range(6)]
    b = torch.tensor([list(v.to_bytes(32, "little")) for v in vals],
                     dtype=torch.uint8)
    assert sc.below_l(b).tolist() == [v < ELL for v in vals]
    assert torch.equal(sc.below_l(b),
                       (sc.to_bytes(sc.from_bytes(b)) == b).all(-1))
    assert sc.below_l(b[3]).shape == ()


def _check_selftest_ops_equal_jax_and_integers(rng):
    vals = [int.from_bytes(rng.bytes(32), "little") % ELL, 1, ELL - 1,
            int.from_bytes(rng.bytes(32), "little") % ELL]
    x = torch.stack([sc.from_int(v) for v in vals])
    e = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    e[1] = 0                                        # x^0 = 1
    jx = jnp.asarray(x.numpy())
    rinv = pow(2**256, ELL - 2, ELL)
    cases = {
        "inv": (sc.inv(x), jsc.inv(jx), [pow(v, ELL - 2, ELL) for v in vals]),
        "to_mont": (sc.to_mont(x), jsc.to_mont(jx),
                    [v * 2**256 % ELL for v in vals]),
        "from_mont": (sc.from_mont(x), jsc.from_mont(jx),
                      [v * rinv % ELL for v in vals]),
        "mont_mul": (sc.mont_mul(x, sc.to_mont(x)), jsc.mont_mul(
            jx, jsc.to_mont(jx)), [v * v % ELL for v in vals]),
        "exp_mod_bpo": (sc.exp_mod_bpo(x, torch.from_numpy(e)),
                        jsc.exp_mod_bpo(jx, jnp.asarray(e)),
                        [pow(v, int.from_bytes(row.tobytes(), "little"), ELL)
                         for v, row in zip(vals, e)]),
    }
    for name, (got, want, ints) in cases.items():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
        assert [limbs_to_int(r) for r in got.tolist()] == ints, name
        assert torch.equal(sc.to_bytes(got), torch.from_numpy(np.array(
            jsc.to_bytes(want)))), name
    assert [limbs_to_int(r) for r in sc.mul(cases["inv"][0], x).tolist()] \
        == [1, 1, 1, 1]


@pytest.mark.parametrize("form", ["bits", "bytes", "limbs"])
def test_fold_cuts_equal_jax(rng, form):
    by = rng.integers(0, 256, (16, 32), dtype=np.uint8)
    by[0], by[1] = 0, 255
    if form == "bits":
        x = ((by[..., None] >> np.arange(8)) & 1).reshape(16, 256)
        cuts = ((fold.cut8, jfold.cut8), (fold.cut4, jfold.cut4))
    elif form == "bytes":
        x = by
        cuts = ((fold.cut8_bytes, jfold.cut8_bytes),
                (fold.cut4_bytes, jfold.cut4_bytes))
    else:
        x = np.stack([int_to_limbs(int.from_bytes(r.tobytes(), "little"))
                      for r in by])
        cuts = ((fold.cut8_limbs, jfold.cut8_limbs),
                (fold.cut4_limbs, jfold.cut4_limbs))
    x = x.astype(np.int32) if form == "bits" else x
    for port, ref in cuts:
        np.testing.assert_array_equal(to_numpy(port(from_numpy(x))),
                                      np.asarray(ref(jnp.asarray(x))))


def host_op(lib, name, x, y=None, z=None):
    x = np.ascontiguousarray(x, np.int32)
    y, z = (None if a is None else np.ascontiguousarray(a, np.int32)
            for a in (y, z))
    out = np.zeros((len(x), 32 if name == "cut8" else 20), np.int32)
    rc = lib.sc25519_op_host(OPS[name], out.ctypes.data, x.ctypes.data,
                             None if y is None else y.ctypes.data,
                             None if z is None else z.ctypes.data, len(x))
    assert rc == 0
    return out


def test_host_sc_ops_equal_plain(lib, rng):
    x, y, z, d = _inputs(rng)
    t = [from_numpy(a) for a in (x, y, z)]
    r = raw(rng, 20)
    cases = [("mod", (r,), sc.mod(from_numpy(r))),
             ("add", (x, y), sc.add(t[0], t[1])),
             ("mul", (x, y), sc.mul(t[0], t[1])),
             ("muladd", (x, y, z), sc.muladd(*t)),
             ("sub_from_ell", (x,), sc.sub_from_ell(t[0])),
             ("from_digest", (d.astype(np.int32),), sc.from_digest(from_numpy(d))),
             ("cut8", (x,), fold.cut8_limbs(t[0]))]
    for name, args, want in cases:
        np.testing.assert_array_equal(host_op(lib, name, *args),
                                      to_numpy(want), err_msg=name)
    _check_digits_host(lib, rng)


def int_cut(x, nfolds):
    """The fold digits of the integer x < 2^256 (ops/fold's conventions),
    bit by bit: 8-fold digit c has bit j = bit 32j + 31 - c; 4-fold digit c
    has bit m = bit 32(2m + 1) + 31 - c, digit 32 + c bit m = bit 64m + 31 -
    c."""
    def bit(i):
        return (x >> i) & 1
    if nfolds == 8:
        return [sum(bit(32 * j + 31 - c) << j for j in range(8))
                for c in range(32)]
    return [sum(bit(32 * (2 * m + odd) + 31 - c) << m for m in range(4))
            for odd in (1, 0) for c in range(32)]


def host_digits(lib, md, s, s_stride=32):
    """(u, v) of digits_host over the rows of md [n, 64] and of s (a uint8
    array whose rows of 32 bytes start s_stride bytes apart)."""
    n = len(md)
    u, v = np.zeros((n, 32), np.int32), np.zeros((n, 64), np.int32)
    lib.digits_host(u.ctypes.data, v.ctypes.data, md.ctypes.data, 64,
                    s.ctypes.data, s_stride, n)
    return u, v


def _check_digits_host(lib, rng):
    """digits_host (csrc/digits.cu, verify's fold digits) against the plain
    calls it replaces on a card, fold.cut4_limbs(sc.from_digest(md)) and
    fold.cut8_bytes(s), and both against Python integers: digests at 0,
    2^512 - 1, k*l and k*l +- 1, and around 2^256; S at 0, l - 1, l, l + s,
    2^256 - 1 and the top bit alone (S is cut as its raw bytes, never
    reduced); random rows, also over three of the kernel's 128-lane tiles;
    S read at a stride of 64 from signature rows and broadcast at a stride
    of 0."""
    mds = [0, 2**512 - 1, 2**256 - 1, 2**256, 2**256 + 1, 2**252, ELL]
    for k in (1, 2, 3, 16, 2**64 + 7, 2**200 + 1, (2**512 - 1) // ELL):
        mds += [k * ELL - 1, k * ELL, k * ELL + 1]
    mds += [int.from_bytes(rng.bytes(64), "little") for _ in range(12)]
    valid = int.from_bytes(rng.bytes(32), "little") % ELL
    ss = [0, ELL - 1, ELL, ELL + valid, 2**256 - 1, 2**255, valid]
    ss += [int.from_bytes(rng.bytes(32), "little")
           for _ in range(len(mds) - len(ss))]
    md = np.array([list(x.to_bytes(64, "little")) for x in mds], np.uint8)
    s = np.array([list(x.to_bytes(32, "little")) for x in ss], np.uint8)
    want_u = fold.cut8_bytes(torch.from_numpy(s)).numpy()
    want_v = fold.cut4_limbs(sc.from_digest(torch.from_numpy(md))).numpy()
    assert want_u.tolist() == [int_cut(x, 8) for x in ss]
    assert want_v.tolist() == [int_cut(x % ELL, 4) for x in mds]
    u, v = host_digits(lib, md, s)
    np.testing.assert_array_equal(u, want_u)
    np.testing.assert_array_equal(v, want_v)
    # S in place in 64-byte signature rows, and one S for every row
    sig = np.concatenate([rng.integers(0, 256, s.shape, dtype=np.uint8), s],
                         1)
    u, v = host_digits(lib, md, sig[:, 32:], s_stride=64)
    np.testing.assert_array_equal(u, want_u)
    np.testing.assert_array_equal(v, want_v)
    u, v = host_digits(lib, md, s[3:4].copy(), s_stride=0)
    np.testing.assert_array_equal(u, np.broadcast_to(want_u[3], u.shape))
    np.testing.assert_array_equal(v, want_v)
    # three blocks of the kernel's tiles, the last one partial
    md = rng.integers(0, 256, (300, 64), dtype=np.uint8)
    s = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    u, v = host_digits(lib, md, s)
    np.testing.assert_array_equal(u, fold.cut8_bytes(torch.from_numpy(s)))
    np.testing.assert_array_equal(v, fold.cut4_limbs(sc.from_digest(
        torch.from_numpy(md))))


def test_scalars_follow_the_device_of_their_input():
    x = torch.as_tensor(int_to_limbs(ELL + 5))
    assert sc.mod(x).device == x.device
    assert limbs_to_int(to_numpy(sc.mod(x))) == 5
