"""The port's field core and codecs against the JAX package's, limb for limb.

The same numpy inputs (seeded) go through curve25519_tpu.ops.fe / codec
(jitted once at module level) and curve25519_tpu_torch.ops.fe / codec on the
CPU. Tolerance: exact. Both sides use the same radix, so limbs must be equal,
not just equal mod p.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curve25519_tpu import config as jconfig
from curve25519_tpu.ops import codec as jcodec
from curve25519_tpu.ops import fe as jfe

from curve25519_tpu_torch import config as tconfig
from curve25519_tpu_torch.ops import codec as tcodec
from curve25519_tpu_torch.ops import fe as tfe
from curve25519_tpu_torch.utils import interop
from curve25519_tpu_torch.utils.interop import to_numpy

# the carriers default to the card: these tests ask for the CPU
from_numpy = functools.partial(interop.from_numpy, device="cpu")

P = jconfig.P

# boundary values of tests/test_fe.py
EDGE = [0, 1, 2, 19, 38, P - 1, P - 2, P - 19, 2**255 - 1 - P,
        (1 << 255) % P, (1 << 254) % P, P // 2, P // 2 + 1]


def weak_limbs(rng, n):
    """n random signed-weak limb vectors in [-1217, 9500], then the edge
    values' canonical limbs and the extreme all-min / all-max / alternating
    vectors."""
    lo, hi = jfe.WEAK_MIN, jfe.WEAK_MAX
    rand = rng.integers(lo, hi + 1, (n, 20)).astype(np.int32)
    edge = np.stack([jconfig.int_to_limbs(v) for v in EDGE])
    alt = np.where(np.arange(20) % 2 == 0, hi, lo).astype(np.int32)
    extreme = np.stack([np.full(20, lo), np.full(20, hi), alt, alt[::-1]])
    return np.concatenate([rand, edge, extreme.astype(np.int32)])


def as_jax(*arrs):
    return [jnp.asarray(a) for a in arrs]


def as_torch(*arrs):
    return [from_numpy(a) for a in arrs]


@pytest.fixture(scope="module", autouse=True)
def _free_xla_executables():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(20261)


def assert_same(t_out, j_out, what=""):
    t_np, j_np = to_numpy(t_out), np.asarray(j_out)
    assert t_np.dtype == j_np.dtype and t_np.shape == j_np.shape, what
    np.testing.assert_array_equal(t_np, j_np, err_msg=what)


_BINARY = {
    "add": (jfe.add, tfe.add),
    "sub": (jfe.sub, tfe.sub),
    "mul": (jfe.mul, tfe.mul),
    "mul_small_add": (lambda x, y: jfe.mul_small_add(x, jconfig.A24, y),
                      lambda x, y: tfe.mul_small_add(x, tconfig.A24, y)),
    "eq": (jfe.eq, tfe.eq),
}
_UNARY = {
    "neg": (jfe.neg, tfe.neg),
    "sqr": (jfe.sqr, tfe.sqr),
    "canon": (jfe.canon, tfe.canon),
    "to_bytes": (jfe.to_bytes, tfe.to_bytes),
    "is_zero": (jfe.is_zero, tfe.is_zero),
}
_JIT = {name: jax.jit(pair[0]) for name, pair in {**_BINARY, **_UNARY}.items()}
_JIT_INV = jax.jit(jfe.inv)


def test_constants_match_the_jax_package():
    for name in ("P", "BITS", "NLIMBS", "MASK", "FOLD", "A24", "MONT_BASE_U",
                 "SQRT_M1", "ELL", "ED_D", "ED_2D", "ED_DI", "ED_BX",
                 "ED_BY"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    for v in EDGE + [2**260 - 1]:
        np.testing.assert_array_equal(tconfig.int_to_limbs(v),
                                      jconfig.int_to_limbs(v))
    for name in ("_SUB_PAD", "_CANON_PAD", "_P_LIMBS", "_FB_J", "_FB_S",
                 "_TB_I", "_TB_S"):
        np.testing.assert_array_equal(getattr(tfe, name), getattr(jfe, name))


@pytest.mark.parametrize("name", sorted(_BINARY))
def test_binary_op_limbs_equal_jax(name, rng):
    x, y = weak_limbs(rng, 64), weak_limbs(rng, 64)[::-1].copy()
    want = _JIT[name](*as_jax(x, y))
    got = _BINARY[name][1](*as_torch(x, y))
    assert_same(got, want)
    # broadcasting one element against the batch, as the JAX op allows
    got_b = _BINARY[name][1](*as_torch(x[:1], y))
    assert_same(got_b, _JIT[name](*as_jax(np.broadcast_to(x[:1], y.shape), y)))


def test_unary_ops_limbs_equal_jax(rng):
    x = weak_limbs(rng, 64)
    for name, (_, torch_fn) in sorted(_UNARY.items()):
        assert_same(torch_fn(*as_torch(x)), _JIT[name](*as_jax(x)), name)


def test_outputs_stay_signed_weak(rng):
    x, y = as_torch(weak_limbs(rng, 256), weak_limbs(rng, 256)[::-1].copy())
    for out in (tfe.add(x, y), tfe.sub(x, y), tfe.neg(y), tfe.mul(x, y),
                tfe.sqr(x), tfe.mul_small_add(x, tconfig.A24, y)):
        assert int(out.min()) >= tfe.WEAK_MIN
        assert int(out.max()) <= tfe.WEAK_MAX


def test_inv_limbs_equal_jax(rng):
    x = weak_limbs(rng, 12)
    want = _JIT_INV(*as_jax(x))
    got = tfe.inv(*as_torch(x))
    assert_same(got, want)
    # and it is the inverse: canon(x * inv(x)) == 1 where x != 0 mod p
    nz = ~tfe.is_zero(as_torch(x)[0])
    one = tfe.canon(tfe.mul(as_torch(x)[0], got))[nz]
    assert torch.equal(one, tfe.one(one.shape[:-1]).expand_as(one))


def test_from_bytes_equals_jax(rng):
    b = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    edge = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                     for v in EDGE + [2**256 - 1, P, P + 1]])
    b = np.concatenate([b, edge])
    assert_same(tfe.from_bytes(from_numpy(b)), jax.jit(jfe.from_bytes)(b))
    # to_bytes o from_bytes is the canonical encoding of the value mod p
    back = to_numpy(tfe.to_bytes(tfe.from_bytes(from_numpy(b))))
    for row, enc in zip(back, b):
        assert bytes(row) == (int.from_bytes(enc.tobytes(), "little")
                              % P).to_bytes(32, "little")


def test_pow2523_and_sqrt_ratio_match_python_ints(rng):
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(6)]
    x = from_numpy(np.stack([tconfig.int_to_limbs(v) for v in vals]))
    got = [tconfig.limbs_to_int(r) for r in to_numpy(tfe.canon(tfe.pow2523(x)))]
    assert got == [pow(v, (P - 5) // 8, P) for v in vals]

    vs = [int.from_bytes(rng.bytes(32), "little") % P or 1 for _ in range(8)]
    us = [(r * r * v) % P for r, v in zip(vals[:4], vs[:4])] + vals[:4]
    u = from_numpy(np.stack([tconfig.int_to_limbs(a) for a in us]))
    v = from_numpy(np.stack([tconfig.int_to_limbs(a) for a in vs]))
    root, ok = tfe.sqrt_ratio(u, v)
    roots = [tconfig.limbs_to_int(r) for r in to_numpy(tfe.canon(root))]
    for i in range(8):
        ratio = us[i] * pow(vs[i], P - 2, P) % P
        is_sq = pow(ratio, (P - 1) // 2, P) in (0, 1)
        assert bool(ok[i]) == is_sq
        if is_sq:
            assert (roots[i] * roots[i] - ratio) % P == 0


def test_select(rng):
    x, y = weak_limbs(rng, 16), weak_limbs(rng, 16)[::-1].copy()
    mask = rng.integers(0, 2, len(x)).astype(bool)
    got = tfe.select(torch.from_numpy(mask), *as_torch(x, y))
    assert_same(got, jfe.select(jnp.asarray(mask), *as_jax(x, y)))


def test_codec_equals_jax(rng):
    sk = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    ts = from_numpy(sk)
    assert_same(tcodec.clamp(ts), jcodec.clamp(sk))
    assert torch.equal(ts, from_numpy(sk)), "clamp must not modify its input"
    assert_same(tcodec.scalar_bits(ts), jcodec.scalar_bits(sk))
    parity = rng.integers(0, 2, 32).astype(np.int32)
    assert_same(tcodec.pack_point(ts, from_numpy(parity)),
                jcodec.pack_point(jnp.asarray(sk), jnp.asarray(parity)))
    y_t, par_t = tcodec.unpack_parity(ts)
    y_j, par_j = jcodec.unpack_parity(jnp.asarray(sk))
    assert_same(y_t, y_j)
    assert_same(par_t, par_j)


def test_interop_keeps_dtype_and_values(rng):
    limbs = weak_limbs(rng, 4)
    enc = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    for arr in (limbs, enc, jnp.asarray(enc)):
        t = from_numpy(arr)
        assert t.dtype in (torch.int32, torch.uint8)
        np.testing.assert_array_equal(to_numpy(t), np.asarray(arr))
    with pytest.raises(TypeError):
        from_numpy(limbs.astype(np.int64))
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError):
            interop.from_numpy(enc)
