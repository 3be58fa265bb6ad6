"""The port's Ed25519 verify slice against the JAX package's.

Inputs: the 16 edge vectors of tests/test_edge_encodings.py, then the
port's own signatures (valid, tampered R and S, a wrong message, a shorter
msg_len, a key off the curve), as one batch of 16-byte messages, and digits
and limbs from a seeded numpy generator. On the CPU the port runs the plain
versions of the verify kernels (ops/cuda/verify_kernel.py); the g++ build
of the kernels' lane code (csrc/verify.cu) is held against them.

The JAX side runs its CPU route once per module, in the `jax_ref` fixture:
verify_init and unpack_point eagerly, verify_check and _poly_point_multiply
in one jitted function (jitting verify_init as well costs ~90 s more of XLA
compile on a CPU; eager verify_check costs more than its compile). Strict
and table-free verdicts are held against the frozen expectations of the
vectors, to which tests/test_edge_encodings.py holds the JAX package.
Tolerance: exact bytes, limbs and verdicts.
"""

import functools
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curve25519_tpu import refmodel
from curve25519_tpu.models import ed25519 as jed25519
from curve25519_tpu.models import tables as jtables
from curve25519_tpu.ops import fe as jfe

from curve25519_tpu_torch.models import ed25519, edwards, tables
from curve25519_tpu_torch.ops import fe, fold, sc
from curve25519_tpu_torch.ops.cuda import build, edwards_kernel, verify_kernel
from curve25519_tpu_torch.utils import interop
from curve25519_tpu_torch.utils.interop import to_numpy

from test_edge_encodings import MSG, VECTORS

# the carriers default to the card: these tests ask for the CPU
from_numpy = functools.partial(interop.from_numpy, device="cpu")
verify_ctx_from_jax = functools.partial(interop.verify_ctx_from_jax,
                                        device="cpu")

N_EDGE = len(VECTORS)
# the port's own lanes after the edge vectors: name -> expected verdict
OWN = {"valid": True, "tampered-R": False, "tampered-S": False,
       "wrong-msg": False, "short-msg-len": True, "long-msg-len": False,
       "pk-off-curve": False}


@pytest.fixture(scope="module", autouse=True)
def _free_xla_executables():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def batch():
    """(pk, sig, msg, msg_len, verdict, strict verdict) numpy arrays: the
    edge vectors, then the lanes of OWN."""
    rng = np.random.default_rng(3)
    sk = from_numpy(rng.integers(0, 256, (2, 32), dtype=np.uint8))
    pk_own, priv = ed25519.create_keypair(sk)
    msg = rng.integers(0, 256, (2, len(MSG)), dtype=np.uint8)
    lens = np.array([len(MSG), 9], np.int32)
    sig_own = to_numpy(ed25519.sign(priv, from_numpy(msg), from_numpy(lens)))
    pk_own = to_numpy(pk_own)
    rows = {"valid": (0, sig_own[0], msg[0], len(MSG)),
            "tampered-R": (0, sig_own[0] ^ np.eye(64, dtype=np.uint8)[5],
                           msg[0], len(MSG)),
            "tampered-S": (0, sig_own[0] ^ np.eye(64, dtype=np.uint8)[40],
                           msg[0], len(MSG)),
            "wrong-msg": (0, sig_own[0], msg[0] ^ np.eye(
                len(MSG), dtype=np.uint8)[3], len(MSG)),
            "short-msg-len": (1, sig_own[1], msg[1], 9),
            "long-msg-len": (1, sig_own[1], msg[1], len(MSG)),
            "pk-off-curve": (None, sig_own[0], msg[0], len(MSG))}
    off_curve = np.frombuffer((2).to_bytes(32, "little"), np.uint8)
    pk = [np.frombuffer(v[1], np.uint8) for v in VECTORS] + [
        off_curve if k is None else pk_own[k] for k, _, _, _ in rows.values()]
    sig = [np.frombuffer(v[2], np.uint8) for v in VECTORS] + [
        r[1] for r in rows.values()]
    m = [np.frombuffer(v[3], np.uint8) for v in VECTORS] + [
        r[2] for r in rows.values()]
    n = [len(MSG)] * N_EDGE + [r[3] for r in rows.values()]
    want = [v[4] for v in VECTORS] + list(OWN.values())
    want_strict = [v[5] for v in VECTORS] + list(OWN.values())
    return (np.stack(pk), np.stack(sig), np.stack(m), np.array(n, np.int32),
            np.array(want), np.array(want_strict))


_jax_check_and_poly = jax.jit(lambda ctx, sig, msg, n, u, v: (
    jed25519.verify_check(ctx, sig, msg, n),
    jed25519._pack(*jed25519._poly_point_multiply(u, v, ctx["planes"]))))


@pytest.fixture(scope="module")
def digits():
    """Random (u, v) fold digits for the batch's lanes: s any 32 bytes, h
    reduced mod l."""
    rng = np.random.default_rng(4)
    lanes = N_EDGE + len(OWN)
    s = rng.integers(0, 256, (lanes, 32), dtype=np.uint8)
    md = rng.integers(0, 256, (lanes, 64), dtype=np.uint8)
    return (to_numpy(fold.cut8_bytes(from_numpy(s))),
            to_numpy(fold.cut4_limbs(sc.from_digest(from_numpy(md)))))


@pytest.fixture(scope="module")
def jax_ref(batch, digits):
    pk, sig, msg, n, _, _ = batch
    ctx = jed25519.verify_init(pk)
    q, ok = jed25519.unpack_point(pk, negate=True)
    verdict, poly = _jax_check_and_poly(ctx, sig, msg, n, *digits)
    out = {k: np.asarray(v) for k, v in ctx.items()}
    out.update(verdict=np.asarray(verdict), poly=np.asarray(poly),
               q={k: np.asarray(v) for k, v in q.items()},
               q_ok=np.asarray(ok))
    return out


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    return build.load_host(build.build_host(tmp_path_factory.mktemp("host")))


def t(a):
    return from_numpy(np.ascontiguousarray(a))


def test_vectors_expectations_and_jax_verdicts(batch, jax_ref):
    """The batch's expected verdicts are the JAX package's verify_check."""
    *_, want, _ = batch
    np.testing.assert_array_equal(jax_ref["verdict"], want)


def test_unpack_point_and_calculate_x_equal_jax(batch, jax_ref):
    """Valid keys, keys off the curve, y >= p, x = 0 with the sign bit."""
    pk = t(batch[0])
    q, ok = ed25519.unpack_point(pk, negate=True)
    for k in ("x", "y", "z", "t"):
        np.testing.assert_array_equal(to_numpy(q[k].expand_as(q["y"])),
                                      np.broadcast_to(jax_ref["q"][k],
                                                      q["y"].shape), err_msg=k)
    np.testing.assert_array_equal(to_numpy(ok), jax_ref["q_ok"])
    y = fe.from_bytes(pk & torch.tensor([255] * 31 + [127], dtype=torch.uint8))
    x, ok2 = ed25519.calculate_x(y, 1 - (pk[:, 31] >> 7).to(torch.int32))
    assert torch.equal(x, q["x"]) and torch.equal(ok2, ok)
    assert not ok.all() and ok.any()


def test_pe_planes_and_gather_pe_equal_jax():
    rng = np.random.default_rng(5)
    arr = rng.integers(jfe.WEAK_MIN, jfe.WEAK_MAX + 1, (3, 16, 4, 20),
                       dtype=np.int32)
    planes = tables.pe_planes_from_array(t(arr))
    np.testing.assert_array_equal(
        to_numpy(planes), np.asarray(jtables.pe_planes_from_array(arr)))
    canon = to_numpy(fe.canon(t(arr)))
    np.testing.assert_array_equal(
        to_numpy(tables.pe_planes_from_canonical(t(canon))),
        np.asarray(jtables.pe_planes_from_canonical(canon)))
    idx = rng.integers(0, 16, (3,)).astype(np.int32)
    for p in (planes, planes[1]):        # a table per lane, one for all
        got = tables.gather_pe(t(idx), p)
        want = jtables.gather_pe(jnp.asarray(idx), jnp.asarray(to_numpy(p)))
        for k in ("ypx", "ymx", "t2d", "z2"):
            np.testing.assert_array_equal(to_numpy(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_verify_init_equals_jax(batch, jax_ref):
    pk = t(batch[0])
    ctx = ed25519.verify_init(pk)
    np.testing.assert_array_equal(to_numpy(ctx["planes"]), jax_ref["planes"])
    np.testing.assert_array_equal(to_numpy(ctx["ok"]), jax_ref["ok"])
    assert ctx["planes"].dtype == torch.int8
    one = ed25519.verify_init(pk[N_EDGE])       # unbatched: [16, 160]
    assert one["planes"].shape == (16, 160)
    np.testing.assert_array_equal(to_numpy(one["planes"]),
                                  jax_ref["planes"][N_EDGE])


def test_poly_point_multiply_equals_jax(batch, digits, jax_ref):
    u, v = (t(d) for d in digits)
    planes = t(jax_ref["planes"])
    got = edwards.pack(*edwards.poly_point_mult(u, v, planes))
    np.testing.assert_array_equal(to_numpy(got), jax_ref["poly"])
    assert torch.equal(verify_kernel.poly_mult(u, v, planes), got)


@pytest.mark.parametrize("strict", [False, True], ids=["nonstrict", "strict"])
def test_verdicts_equal_jax_and_frozen(batch, jax_ref, strict):
    """verify, verify_check (per-lane and shared) and verify_tablefree on
    the edge vectors and the port's own signatures."""
    pk, sig, msg, n, want, want_strict = (t(a) for a in batch)
    expect = want_strict if strict else want
    if not strict:
        assert torch.equal(expect, t(jax_ref["verdict"]))
    ctx = ed25519.verify_init(pk)
    got = {"verify": ed25519.verify(sig, pk, msg, n, strict=strict),
           "verify_check": ed25519.verify_check(ctx, sig, msg, n,
                                                strict=strict),
           "verify_tablefree": ed25519.verify_tablefree(sig, pk, msg, n,
                                                        strict=strict)}
    shared = torch.zeros_like(expect)
    for key in torch.unique(pk, dim=0):         # one unbatched context per key
        lanes = (pk == key).all(-1)
        shared[lanes] = ed25519.verify_check(ed25519.verify_init(key),
                                             sig[lanes], msg[lanes],
                                             n[lanes], strict=strict)
    got["shared verify_check"] = shared
    names = [v[0] for v in VECTORS] + list(OWN)
    for label, g in got.items():
        bad = [nm for nm, a, b in zip(names, g.tolist(), expect.tolist())
               if a != b]
        assert not bad, (label, bad)


def test_verify_ctx_from_jax_gives_jax_verdicts(batch, jax_ref):
    pk, sig, msg, n, want, _ = batch
    ctx = verify_ctx_from_jax({k: jax_ref[k] for k in ("pk", "planes", "ok")})
    assert ctx["planes"].dtype == torch.int8 and ctx["ok"].dtype == torch.bool
    got = ed25519.verify_check(ctx, t(sig), t(msg), t(n))
    np.testing.assert_array_equal(to_numpy(got), jax_ref["verdict"])
    ed25519.verify_finish(ctx)
    assert list(ctx) == ["pk"]


def test_rank1_and_broadcast_calls(batch):
    pk, sig, msg, n, want, _ = (t(a) for a in batch)
    i = N_EDGE                                   # the port's valid signature
    assert bool(ed25519.verify(sig[i], pk[i], msg[i], n[i]))
    ctx = ed25519.verify_init(pk[i])
    assert bool(ed25519.verify_check(ctx, sig[i], msg[i], n[i]))
    # one key over several messages, numpy and list inputs on the CPU
    got = ed25519.verify(to_numpy(sig[i:i + 4]), to_numpy(pk[i]),
                         to_numpy(msg[i:i + 4]), n[i:i + 4].tolist(),
                         device="cpu")
    assert got.tolist() == want[i:i + 4].tolist()
    assert refmodel.ed_verify(bytes(to_numpy(sig[i])), bytes(to_numpy(pk[i])),
                              bytes(to_numpy(msg[i])))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ed25519.verify(to_numpy(sig[i]), to_numpy(pk[i]), to_numpy(msg[i]))


def test_host_kernels_equal_plain(lib, batch, digits):
    """verify.cu's and oneshot.cu's lane code built with g++: Verify_Init
    (valid and invalid keys), the double-scalar multiply with per-lane and
    shared q_tables, the one-shot kernel with its scratch layout, pow2523
    and sqrt_ratio."""
    pk = np.ascontiguousarray(batch[0])
    u, v = (np.ascontiguousarray(d) for d in digits)
    n = len(pk)
    planes = np.zeros((n, 16, 160), np.int8)
    ok = np.zeros(n, np.uint8)
    lib.verify_init_host(planes.ctypes.data, ok.ctypes.data, pk.ctypes.data, n)
    want_planes, want_ok = verify_kernel.verify_init_plain(t(pk))
    np.testing.assert_array_equal(planes, to_numpy(want_planes))
    np.testing.assert_array_equal(ok.astype(bool), to_numpy(want_ok))
    assert not ok.all() and ok.any()
    table = to_numpy(edwards_kernel.packed_table(8, torch.device("cpu")))
    for shared in (False, True):
        q = planes[3] if shared else planes
        out = np.zeros((n, 32), np.uint8)
        lib.poly_host(out.ctypes.data, u.ctypes.data, v.ctypes.data,
                      np.ascontiguousarray(q).ctypes.data, int(shared),
                      table.ctypes.data, n)
        want = verify_kernel.poly_mult_plain(t(u), t(v), t(q))
        np.testing.assert_array_equal(out, to_numpy(want), err_msg=shared)
    out = np.zeros((n, 32), np.uint8)
    ok1 = np.zeros(n, np.uint8)
    scratch = np.zeros((n, 16, 80), np.int16)
    lib.oneshot_host(out.ctypes.data, ok1.ctypes.data, scratch.ctypes.data,
                     pk.ctypes.data, u.ctypes.data, v.ctypes.data,
                     table.ctypes.data, n)
    want_r, want_ok = verify_kernel.verify_oneshot_plain(t(pk), t(u), t(v))
    np.testing.assert_array_equal(out, to_numpy(want_r))
    np.testing.assert_array_equal(ok1.astype(bool), to_numpy(want_ok))
    # the one-shot scratch row holds the q_table as int16 canonical limbs:
    # the limbs lo + (hi << 7) of the int8 planes
    limbs = planes[..., :80].astype(np.int16) + (planes[..., 80:].astype(
        np.int16) << 7)
    np.testing.assert_array_equal(scratch, limbs)
    # the launch's scratch: a 256-thread block per 256 lanes, one per SM
    assert [lib.oneshot_scratch_rows(m, 132) for m in (1, 256, 257, 1 << 40)
            ] == [256, 256, 512, 132 * 256]

    rng = np.random.default_rng(6)
    x = rng.integers(jfe.WEAK_MIN, jfe.WEAK_MAX + 1, (8, 20), dtype=np.int32)
    x[0] = 0
    got = np.zeros_like(x)
    assert lib.fe25519_op_host(10, got.ctypes.data, x.ctypes.data, None,
                               len(x)) == 0          # FE_POW2523
    np.testing.assert_array_equal(got, to_numpy(fe.pow2523(t(x))))
    uu, vv = x.copy(), x[::-1].copy()
    vv[1] = 0                                    # v = 0
    uu[2] = to_numpy(fe.mul(fe.sqr(t(vv[2])), t(vv[2])))   # u/v = v^2
    sx, sok = np.zeros_like(x), np.zeros(len(x), np.int32)
    lib.sqrt_ratio_host(sx.ctypes.data, sok.ctypes.data, uu.ctypes.data,
                        vv.ctypes.data, len(x))
    wx, wok = fe.sqrt_ratio(t(uu), t(vv))
    np.testing.assert_array_equal(sx, to_numpy(wx))
    np.testing.assert_array_equal(sok.astype(bool), to_numpy(wok))
