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

Ragged batches (verify_ragged) are held against the Python oracle, and the
JAX package's verify_ragged, with its verify_init and jitted check swapped
for the port's, must route every bucket as the port does: verify_init once
per batch or never with a ctx, the shared q_table for one key. The JAX
package's own sign_ragged and verify_ragged, compiled, are held against the
port's in the slow tier. Verify contexts cross between the packages through
utils/checkpoint both ways. Tolerance: exact bytes, limbs and verdicts.
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
from curve25519_tpu.utils import checkpoint as jcheckpoint

from curve25519_tpu_torch.models import ed25519, edwards, tables
from curve25519_tpu_torch.ops import fe, fold, sc
from curve25519_tpu_torch.ops.cuda import build, edwards_kernel, verify_kernel
from curve25519_tpu_torch.utils import checkpoint, interop
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


def test_verify_ctx_from_jax_gives_jax_verdicts(batch, jax_ref, tmp_path):
    pk, sig, msg, n, want, _ = batch
    ctx = verify_ctx_from_jax({k: jax_ref[k] for k in ("pk", "planes", "ok")})
    assert ctx["planes"].dtype == torch.int8 and ctx["ok"].dtype == torch.bool
    got = ed25519.verify_check(ctx, t(sig), t(msg), t(n))
    np.testing.assert_array_equal(to_numpy(got), jax_ref["verdict"])
    _check_checkpoint_crosses_between_packages(ctx, batch, jax_ref, tmp_path)
    ed25519.verify_finish(ctx)
    assert list(ctx) == ["pk"]


def _check_checkpoint_crosses_between_packages(ctx, batch, jax_ref,
                                               tmp_path):
    """A verify ctx saved by either package loads in the other, byte for
    byte, and gives the same verdicts; both files hold the same entries."""
    _, sig, msg, n, _, _ = batch
    as_np = {k: to_numpy(v) for k, v in ctx.items()}
    # the port saves ("_" keys are not saved), the JAX package loads (numpy)
    checkpoint.save_verify_ctx(tmp_path / "port", dict(ctx, _host_only=7))
    got = jcheckpoint.load_pytree(tmp_path / "port", to_jax=False)
    assert sorted(got) == ["ok", "pk", "planes"]
    for k in got:
        assert got[k].dtype == as_np[k].dtype and got[k].tobytes() == \
            as_np[k].tobytes(), k
    # the JAX package saves, the port loads, on the device asked for
    jcheckpoint.save_pytree(str(tmp_path / "jax"), dict(as_np, _host_only=7))
    back = checkpoint.load_verify_ctx(tmp_path / "jax", device="cpu")
    for k in ("pk", "planes", "ok"):
        assert torch.equal(back[k], ctx[k]), k
    np.testing.assert_array_equal(to_numpy(ed25519.verify_check(
        back, t(sig), t(msg), t(n))), jax_ref["verdict"])
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path /
                                                      "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    # any tree of lists, tuples and dicts; numpy on request
    tree = {"b": [torch.arange(3, dtype=torch.int32), (torch.ones(
        2, dtype=torch.bool),)], "a": torch.zeros(1, dtype=torch.uint8)}
    checkpoint.save_pytree(tmp_path / "tree.npz", tree)
    back = checkpoint.load_pytree(tmp_path / "tree.npz", device="cpu")
    assert isinstance(back["b"], list) and isinstance(back["b"][1], tuple)
    assert torch.equal(back["b"][0], tree["b"][0])
    assert isinstance(checkpoint.load_pytree(tmp_path / "tree",
                                             to_torch=False)["a"], np.ndarray)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            checkpoint.load_verify_ctx(tmp_path / "jax")


def test_rank1_and_broadcast_calls(batch, monkeypatch):
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
    _check_verify_ragged_routes_as_jax(monkeypatch)


def ragged_case():
    """(pk [4, 32], priv [4, 64], 4 messages in 2 buckets) on the CPU."""
    rng = np.random.default_rng(44)
    pk, priv = ed25519.create_keypair(from_numpy(rng.integers(
        0, 256, (4, 32), dtype=np.uint8)))
    return pk, priv, [rng.bytes(n) for n in (200, 5, 111, 150)]


def _check_verify_ragged_routes_as_jax(monkeypatch):
    """verify_ragged with per-lane keys, a per-lane ctx, one rank-1 key and
    an unbatched ctx: the oracle's verdicts, and the same routing as the
    JAX package's verify_ragged run with the port's verify_init and check
    (verify_init once or never; per-lane or shared q_tables per bucket)."""
    pk, priv, msgs = ragged_case()
    sig = ed25519.sign_ragged(priv, msgs)
    sig[1, 3] ^= 1                                  # R
    sig[3, 40] ^= 1                                 # S
    sig1 = ed25519.sign_ragged(priv[0], msgs)
    sig1[2, 63] ^= 1
    want = [refmodel.ed_verify(bytes(to_numpy(s)), bytes(to_numpy(k)), m)
            for s, k, m in zip(sig, pk, msgs)]
    assert want == [True, False, True, False]

    port_log, jax_log = [], []
    real_init, real_poly = ed25519.verify_init, verify_kernel.poly_mult
    monkeypatch.setattr(ed25519, "verify_init", lambda *a, **k: (
        port_log.append("init") or real_init(*a, **k)))
    monkeypatch.setattr(verify_kernel, "poly_mult", lambda u, v, planes: (
        port_log.append(planes.ndim) or real_poly(u, v, planes)))

    def jax_init(pk):
        jax_log.append("init")
        return {k: to_numpy(v) for k, v in real_init(t(pk)).items()}

    def jax_check(m, l, s, planes, ok, pkb, strict):
        jax_log.append(np.ndim(planes))
        return to_numpy(ed25519.verify_check(
            {"pk": t(pkb), "planes": t(planes), "ok": t(ok)}, t(s), t(m),
            t(l), strict=strict))

    monkeypatch.setattr(jed25519, "verify_init", jax_init)
    monkeypatch.setattr(jed25519, "_vcheck_jit", jax_check)
    ctx, ctx1 = real_init(pk), real_init(pk[0])
    for s, k, c, verdicts, route in (
            (sig, pk, None, want, ["init", 3, 3]),
            (sig, None, ctx, want, [3, 3]),
            (sig1, pk[0], None, [True, True, False, True], ["init", 2, 2]),
            (sig1, None, ctx1, [True, True, False, True], [2, 2])):
        port_log.clear()
        got = ed25519.verify_ragged(s, k, msgs, ctx=c)
        assert (got.tolist(), port_log) == (verdicts, route)
        jax_log.clear()
        jgot = jed25519.verify_ragged(
            to_numpy(s), None if k is None else to_numpy(k), msgs,
            ctx=None if c is None else {n: to_numpy(v) for n, v in c.items()})
        assert (np.asarray(jgot).tolist(), jax_log) == (verdicts, route)


@pytest.mark.slow
def test_ragged_equals_jax_sign_and_verify_ragged(monkeypatch):
    """The JAX package's own sign_ragged and verify_ragged, compiled on the
    CPU, against the port's on 2 messages in one bucket: per-lane keys
    (verify_init counted), a per-lane ctx, and one rank-1 key (the shared
    q_table). In the slow tier, as tests/conftest.py keeps every big XLA
    compile: sign, verify_init and both checks compile for minutes."""
    pk, priv, msgs = ragged_case()
    msgs = msgs[::3]                                # 200 and 150 bytes
    pk, priv = pk[::3], priv[::3]
    sig = ed25519.sign_ragged(priv, msgs)
    np.testing.assert_array_equal(
        np.asarray(jed25519.sign_ragged(to_numpy(priv), msgs)),
        to_numpy(sig))
    sig[1, 40] ^= 1
    inits = []
    real_init = jed25519.verify_init
    monkeypatch.setattr(jed25519, "verify_init", lambda *a: (
        inits.append(1) or real_init(*a)))
    got = ed25519.verify_ragged(sig, pk, msgs)
    assert got.tolist() == [True, False]
    jctx = {k: jnp.asarray(to_numpy(v)) for k, v in
            ed25519.verify_init(pk).items()}
    for k, c in ((to_numpy(pk), None), (None, jctx)):
        np.testing.assert_array_equal(np.asarray(jed25519.verify_ragged(
            to_numpy(sig), k, msgs, ctx=c)), to_numpy(got))
    assert len(inits) == 1                          # none with a ctx
    sig1 = ed25519.sign_ragged(priv[0], msgs)
    np.testing.assert_array_equal(
        np.asarray(jed25519.sign_ragged(to_numpy(priv[0]), msgs)),
        to_numpy(sig1))
    np.testing.assert_array_equal(np.asarray(jed25519.verify_ragged(
        to_numpy(sig1), to_numpy(pk[0]), msgs)), to_numpy(
            ed25519.verify_ragged(sig1, pk[0], msgs)))


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
