"""The port's Ed25519 verify slice against the JAX package's.

Inputs: the 16 edge vectors of tests/test_edge_encodings.py, then the
port's own signatures (valid, tampered R and S, a wrong message, a shorter
msg_len, a key off the curve), as one batch of 16-byte messages, and digits
and limbs from a seeded numpy generator. On the CPU the port runs the plain
versions of the verify kernels (ops/cuda/verify_kernel.py); the g++ build
of the kernels' lane code (csrc/verify.cu, poly.cu, oneshot.cu) is held
against them.

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
utils/checkpoint both ways. The benchmark's EdDSA JWT tokens (48 signing
inputs of 200-1,000 bytes under one key, made by portbench's
jwt_eddsa_gateway deployment, S + L among the faults) go through one key's
context and verify_check(strict=True), held against portbench's
Python-integer reference and the JAX package's strict verify_check, with
their program spans recorded. The benchmark's Solana votes (64 votes
under 8 cached staked keys and one key outside them, made by portbench's
solana_vote_sigverify deployment, with an undecodable key cached and one
not cached, and S + L lanes) go through verify_cached, strict and not,
held against verify and the Python-integer reference, with its spans and
its tally of cached and missed lanes; poly.cu's keyed lane (g++) is held
against its plain version and against the per-lane q_tables. Tolerance:
exact bytes, limbs and verdicts.
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
from curve25519_tpu_torch.utils import checkpoint, interop, profiling
from curve25519_tpu_torch.utils.interop import to_numpy

from portbench import harness
from portbench.deployments import jwt_eddsa_gateway as jwt
from portbench.deployments import solana_vote_sigverify as votes
from portbench.reference import curve

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
_jax_strict_check = jax.jit(lambda ctx, sig, msg, n: jed25519.verify_check(
    ctx, sig, msg, n, strict=True))


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
def lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    return build.load_host(build.build_host())


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
    if strict:
        _check_jwt_tokens_strict()
    _check_votes_cached(strict)


def jwt_tokens():
    """(pk bytes, sig, msg, msg_len, malleated lanes): 48 EdDSA JWTs of
    200-1,000-byte signing inputs under one seeded key, made by the
    benchmark's jwt_eddsa_gateway deployment with a quarter of them invalid,
    3 of each kind: a bit of R, of S or of the signing input flipped, and S
    replaced by S + L."""
    config = dict(harness.load_json(
        harness.HERE / "configs" / "jwt_eddsa_gateway.json"),
        invalid_one_in=4)
    made = jwt.make(config, {"batch": 48, "pool": 1}, 2**32 + 18)
    lanes = made["lanes"]
    return (made["fixed"]["pk"], lanes["sig"], lanes["msg"],
            lanes["msg_len"], made["strata"]["malleated"])


def vote_batch():
    """(staked keys, pk, sig, msg, msg_len) on the CPU: 64 Solana votes of
    220-330 bytes made by the benchmark's solana_vote_sigverify deployment,
    8 of them (1 in 8) by a key outside the 8 staked ones, 16 invalid;
    then an off-curve key added to the staked ones, which lanes 0-3 carry,
    another that lanes 4-7 carry and no context holds, and S + L in the
    first 4 valid lanes after them (accepted only without strict), which
    come last."""
    config = dict(harness.load_json(
        harness.HERE / "configs" / "solana_vote_sigverify.json"),
        staked_keys=8, unstaked_keys=1, miss_one_in=8, invalid_one_in=4)
    made = votes.make(config, {"batch": 64, "pool": 1}, 2**32 + 22)
    sig, pk, msg, msg_len = (made["lanes"][k].copy()
                             for k in ("sig", "pk", "msg", "msg_len"))
    off = [np.frombuffer(y.to_bytes(32, "little"), np.uint8) for y in (2, 5)]
    pk[0:4], pk[4:8] = off
    malleated = np.setdiff1d(np.arange(8, 64), made["strata"]["invalid"])[:4]
    for lane in malleated:
        s = int.from_bytes(sig[lane, 32:].tobytes(), "little") + curve.L
        sig[lane, 32:] = np.frombuffer(s.to_bytes(32, "little"), np.uint8)
    staked = np.concatenate([made["fixed"]["staked"], off[:1]])
    return staked, pk, sig, msg, msg_len, malleated


def _check_votes_cached(strict):
    """verify_cached of the vote batch against a context of the staked keys
    (and the off-curve one) equals verify and the Python-integer verify
    lane for lane; its tally counts the lanes of keys outside the context
    as misses; its lookup is built once, kept in the context, and not
    saved with it."""
    staked, pk, sig, msg, n, malleated = vote_batch()
    want = [curve.verify(a.tobytes(), b.tobytes(), m[:k].tobytes(), strict)
            for a, b, m, k in zip(sig, pk, msg, n)]
    assert 0 < sum(want) < 64 and not any(want[:8])
    assert [want[i] for i in malleated] == [not strict] * 4
    ctx = ed25519.verify_init(t(staked))
    assert ctx["ok"].tolist() == [True] * 8 + [False]
    cached = (pk[:, None] == staked[None]).all(-1).any(-1)
    misses = 64 - int(cached.sum())
    assert misses == 4 + 8 - int(cached[4:8].sum()) > 8
    tally = {k: int(c) for k, c in verify_kernel.cached_lanes.items()}
    got = ed25519.verify_cached(ctx, t(sig), t(pk), t(msg), t(n),
                                strict=strict)
    assert got.tolist() == want
    assert ed25519.verify(t(sig), t(pk), t(msg), t(n),
                          strict=strict).tolist() == want
    assert {k: int(c) - tally[k] for k, c in verify_kernel.cached_lanes.items()
            } == {"hit": 64 - misses, "miss": misses}
    index = ctx["_keys"]
    assert index[0].tolist() == sorted(index[0].tolist())
    assert bool(ed25519.verify_cached(ctx, t(sig[20]), t(pk[20]), t(msg[20]),
                                      t(n[20]), strict=strict)) == want[20]
    assert ctx["_keys"] is index
    one = ed25519.verify_cached(ed25519.verify_init(t(pk[20])), t(sig),
                                t(pk), t(msg), t(n), strict=strict)
    assert one.tolist() == want


def _check_jwt_tokens_strict():
    """One key's context and verify_check(strict=True) give the verdicts of
    the Python-integer reference and of the JAX package's strict
    verify_check (on the same context); the S + L lanes pass without
    strict and fail with it."""
    pk, sig, msg, n, malleated = jwt_tokens()
    want = [curve.verify(s.tobytes(), pk, m[:k].tobytes(), strict=True)
            for s, m, k in zip(sig, msg, n)]
    assert sum(want) == 36 and len(malleated) == 3
    ctx = ed25519.verify_init(t(np.frombuffer(pk, np.uint8)))
    got = ed25519.verify_check(ctx, t(sig), t(msg), t(n), strict=True)
    assert got.tolist() == want
    jgot = _jax_strict_check({k: to_numpy(v) for k, v in ctx.items()}, sig,
                             msg, n)
    assert np.asarray(jgot).tolist() == want
    loose = ed25519.verify_check(ctx, t(sig[malleated]), t(msg[malleated]),
                                 t(n[malleated]))
    assert loose.tolist() == [True] * 3
    assert not got[torch.from_numpy(malleated)].any()


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
    _check_jwt_spans()
    _check_votes_spans()
    _check_verify_ragged_routes_as_jax(monkeypatch)


def _check_jwt_spans():
    """A recording of one key's verify_init and two verify_check calls over
    the JWT tokens: the CPU route, then the card route's row preparation
    with its launch stubbed out (use_cuda forced, build.launch kept aside),
    which takes the shared q_table. The API spans carry their keys and
    lanes, and verify_kernel.poly_rows its lanes inside the second check."""
    pk, sig, msg, n, _ = jwt_tokens()
    pk, sig, msg, n = t(np.frombuffer(pk, np.uint8)), t(sig), t(msg), t(n)
    launched = []
    profiling.start_spans()
    try:
        ctx = ed25519.verify_init(pk)
        ed25519.verify_check(ctx, sig, msg, n, strict=True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(verify_kernel, "use_cuda", lambda _: True)
            mp.setattr(verify_kernel, "launches", dict(verify_kernel.launches))
            mp.setattr(build, "launch", lambda lib, fn, dev, *args, n=None: (
                launched.append((lib, args[4], n))))
            ed25519.verify_check(ctx, sig, msg, n, strict=True)
            counted = dict(verify_kernel.launches)
    finally:
        records = profiling.stop_spans()
    top = [(name, k) for _, _, name, parent, k in records if parent < 0]
    assert top == [("ed25519.verify_init", 1), ("ed25519.verify_check", 48),
                   ("ed25519.verify_check", 48)]
    rows = [i for i, r in enumerate(records)
            if r[2] == "verify_kernel.poly_rows"]
    assert len(rows) == 1 and records[rows[0]][4] == 48
    # a child of the second verify_check
    assert records[rows[0]][3] == max(i for i, r in enumerate(records)
                                      if r[2] == "ed25519.verify_check")
    assert launched == [("poly", 1, 48)]
    assert counted["poly_shared"] == verify_kernel.launches["poly_shared"] + 1


def _check_votes_spans():
    """A recording of the staked keys' verify_init and two verify_cached
    calls over the vote batch: the CPU route, then the card route's row
    preparation with its launch stubbed out (use_cuda forced, the scratch
    sized without a card, build.launch kept aside). The API spans carry
    their keys and lanes, each verify_cached holds its key_lookup span, the
    second verify_kernel.poly_keyed_rows with its lanes, one launch each of
    the lookup and keyed kernels is counted, and the first call adds its
    hits and misses to the tally."""
    staked, pk, sig, msg, n = (t(a) for a in vote_batch()[:5])
    launched = []
    tally = {k: int(c) for k, c in verify_kernel.cached_lanes.items()}
    profiling.start_spans()
    try:
        ctx = ed25519.verify_init(staked)
        ed25519.verify_cached(ctx, sig, pk, msg, n)
        added = {k: int(c) - tally[k]
                 for k, c in verify_kernel.cached_lanes.items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(verify_kernel, "use_cuda", lambda _: True)
            mp.setattr(verify_kernel, "launches", dict(verify_kernel.launches))
            mp.setattr(verify_kernel, "cached_lanes", {"hit": 0, "miss": 0})
            mp.setattr(verify_kernel, "keyed_scratch_rows",
                       lambda lanes, dev: min(lanes, 16))
            mp.setattr(build, "launch", lambda lib, fn, dev, *args, n=None: (
                launched.append((lib, fn, args[3 if "keyed" in fn else 7],
                                 n))))
            ed25519.verify_cached(ctx, sig, pk, msg, n)
            counted = dict(verify_kernel.launches)
    finally:
        records = profiling.stop_spans()
    top = [(name, k) for _, _, name, parent, k in records if parent < 0]
    assert top == [("ed25519.verify_init", 9), ("ed25519.verify_cached", 64),
                   ("ed25519.verify_cached", 64)]
    calls = [i for i, r in enumerate(records)
             if r[2] == "ed25519.verify_cached"]
    lookups = [r[3] for r in records if r[2] == "ed25519.key_lookup"]
    assert lookups == calls
    rows = [r for r in records if r[2] == "verify_kernel.poly_keyed_rows"]
    assert len(rows) == 1 and rows[0][3] == calls[1] and rows[0][4] == 64
    # the keyed launch's scratch rows, the lookup's keys
    assert launched == [("poly", "key_lookup_launch", 9, 64),
                        ("poly", "poly_keyed_launch", 16, 64)]
    assert counted == dict(verify_kernel.launches, **{
        k: verify_kernel.launches[k] + 1 for k in ("key_lookup",
                                                   "poly_keyed")})
    misses = 64 - int((pk[:, None] == staked[None]).all(-1).any(-1).sum())
    assert added == {"hit": 64 - misses, "miss": misses}


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
    """verify.cu's, poly.cu's and oneshot.cu's lane code (the wide core)
    built with g++: Verify_Init (valid and invalid keys, the edge vectors,
    random keys), the double-scalar multiply with per-lane and shared
    q_tables, and the one-shot kernel with its scratch rows and sizing."""
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
    _check_poly_and_oneshot_host(lib, pk, u, v, planes, shared_lanes=(3,))
    _check_poly_keyed_host(lib, pk, u, v, planes, ok)
    # the launch's scratch: a 512-thread block per 512 lanes, one per SM
    assert [lib.oneshot_scratch_rows(m, 132) for m in (1, 512, 513, 1 << 40)
            ] == [512, 512, 1024, 132 * 512]
    _check_oneshot_split(lib)
    _check_verify_init_host_random_keys(lib)


def _check_oneshot_split(lib):
    """oneshot.cu's lane split over the grid of 132 SMs: every lane taken
    once; each warp a whole group of 32 consecutive lanes from a multiple of
    32 (the batch's last group cut at n), a block's warps of a round its
    first ones and consecutive groups; the blocks' warps balanced to within
    one, and a block's rounds to within a quad of 4 warps (one a scheduler),
    all of them whole quads but the one with the block's last warps; as
    many rounds as 512-lane tiles would take; the busiest block's warps as
    oneshot_busiest_warps gives them (40 at 165,000 lanes, in rounds of 16,
    12 and 12)."""
    busiest = {}
    for n in (1, 31, 33, 512, 513, 67_584, 67_585, 165_000, 262_144, 1 << 20):
        grid = min(-(-n // 512), 132)
        rounds = lib.oneshot_split_host(None, n, grid)
        assert rounds == -(-(-(-n // 512)) // grid), n
        lanes = np.full((rounds, grid, 512), -2, np.int64)
        assert lib.oneshot_split_host(lanes.ctypes.data, n, grid) == rounds
        np.testing.assert_array_equal(np.sort(lanes[lanes >= 0]),
                                      np.arange(n), err_msg=str(n))
        assert (lanes >= -1).all(), n
        warps = lanes.reshape(rounds, grid, 16, 32)
        used = warps[..., 0] >= 0                   # [round, block, warp]
        first = warps[..., 0]
        whole = first[..., None] + np.arange(32)
        whole[whole >= n] = -1
        assert (warps[used] == whole[used]).all() and (first[used] % 32 == 0
                                                       ).all(), n
        assert (used[..., 1:] <= used[..., :-1]).all(), n    # a prefix
        pairs = used[..., 1:]
        assert (np.diff(first, axis=-1)[pairs] == 32).all(), n
        per_round = used.sum(-1)                    # [round, block]
        per_block = per_round.sum(0)
        quads = -(-per_round // 4)
        assert np.ptp(per_block) <= 1 and (np.ptp(quads, axis=0) <= 1).all()
        np.testing.assert_array_equal(quads.sum(0), -(-per_block // 4))
        assert per_block.max() == lib.oneshot_busiest_warps(n, grid) == -(
            -(-(-n // 32)) // grid), n
        busiest[n] = per_round[:, per_block.argmax()].tolist()
    assert busiest[165_000] == [16, 12, 12]
    assert busiest[262_144] == [16, 16, 16, 15]
    assert lib.oneshot_busiest_warps(0, 0) == 0


def _check_poly_and_oneshot_host(lib, pk, u, v, planes, shared_lanes):
    """poly_host with the lanes' q_tables and with the q_table of each lane
    of `shared_lanes` for every lane, and oneshot_host, against
    poly_mult_plain and verify_oneshot_plain; the one-shot scratch rows hold
    the planes of Verify_Init."""
    n = len(pk)
    table = to_numpy(edwards_kernel.word_table(8, torch.device("cpu")))
    for q in [planes] + [planes[i] for i in shared_lanes]:
        q = np.ascontiguousarray(q)
        out = np.zeros((n, 32), np.uint8)
        lib.poly_host(out.ctypes.data, u.ctypes.data, v.ctypes.data,
                      q.ctypes.data, int(q.ndim == 2), table.ctypes.data, n)
        want = verify_kernel.poly_mult_plain(t(u), t(v), t(q))
        np.testing.assert_array_equal(out, to_numpy(want),
                                      err_msg=str(q.shape))
    out = np.zeros((n, 32), np.uint8)
    ok = np.zeros(n, np.uint8)
    scratch = np.zeros((n, 16, 160), np.int8)
    lib.oneshot_host(out.ctypes.data, ok.ctypes.data, scratch.ctypes.data,
                     pk.ctypes.data, u.ctypes.data, v.ctypes.data,
                     table.ctypes.data, n)
    want_r, want_ok = verify_kernel.verify_oneshot_plain(t(pk), t(u), t(v))
    np.testing.assert_array_equal(out, to_numpy(want_r))
    np.testing.assert_array_equal(ok.astype(bool), to_numpy(want_ok))
    np.testing.assert_array_equal(scratch, planes)


def _check_poly_keyed_host(lib, pk, u, v, planes, ok):
    """poly.cu's lookup lane (key_lookup_host) against key_lookup_plain on
    the even lanes' keys, among them duplicates, keys sharing a prefix and
    one changed past its prefix; then its keyed lane (poly_keyed_host, the
    kernel's threads in turn) over a table of the even lanes' q_tables, the
    odd lanes keyed -1 (each its own Verify_Init): equal to
    poly_keyed_plain, and to the multiply and flags of the lanes' own
    q_tables, with scratch rows for every miss, for a few and for one (its
    thread takes every miss in turn); the scratch of a launch is one full
    wave of threads at most."""
    n = len(pk)
    _check_key_lookup_host(lib, pk)
    key = np.where(np.arange(n) % 2 == 0, np.arange(n) // 2,
                   -1).astype(np.int32)
    table, table_ok = np.ascontiguousarray(planes[::2]), ok[::2].copy()
    order = np.argsort(key >= 0, kind="stable").astype(np.int64)
    words = to_numpy(edwards_kernel.word_table(8, torch.device("cpu")))
    want = verify_kernel.poly_keyed_plain(t(u), t(v), t(key), t(table),
                                          t(table_ok.astype(bool)), t(pk))
    r, r_ok = verify_kernel.poly_mult_plain(t(u), t(v), t(planes)), ok
    np.testing.assert_array_equal(to_numpy(want[0]), to_numpy(r))
    np.testing.assert_array_equal(to_numpy(want[1]), r_ok.astype(bool))
    misses = int((key < 0).sum())
    for rows in (misses, 3, 1):
        out = np.zeros((n, 32), np.uint8)
        got_ok = np.full(n, 7, np.uint8)
        scratch = np.zeros((rows, 16, 160), np.int8)
        lib.poly_keyed_host(out.ctypes.data, got_ok.ctypes.data,
                            scratch.ctypes.data, rows, u.ctypes.data,
                            v.ctypes.data, order.ctypes.data,
                            key.ctypes.data, misses, table.ctypes.data,
                            table_ok.ctypes.data, pk.ctypes.data,
                            words.ctypes.data, n)
        np.testing.assert_array_equal(out, to_numpy(want[0]), err_msg=rows)
        np.testing.assert_array_equal(got_ok, ok, err_msg=rows)
    assert [lib.poly_keyed_scratch_rows(m, 132) for m in (1, 50_688, 1 << 40)
            ] == [1, 50_688, 132 * 3 * 128]


def _check_key_lookup_host(lib, pk):
    """key_lookup_host == key_lookup_plain: the rows, the counts, the
    misses' order, and the hits' lanes (the host takes them from the
    back)."""
    keys = pk[::2].copy()
    keys[3, :8] = keys[5, :8]
    keys[4, :8] = keys[5, :8]                   # three keys, one prefix
    lanes = np.concatenate([pk, keys[[5, 3, 4]], keys[:2]])
    lanes[-1, 20] ^= 1                          # a cached prefix, no key
    index = verify_kernel.key_index(t(keys))
    key, order, counts = verify_kernel.key_lookup(t(lanes), t(keys), index)
    m = len(lanes)
    got = (np.zeros(m, np.int32), np.zeros(m, np.int64), np.zeros(2, np.int64))
    prefixes, rows = (np.ascontiguousarray(to_numpy(a)) for a in index)
    lib.key_lookup_host(*(a.ctypes.data for a in got), lanes.ctypes.data,
                        prefixes.ctypes.data, rows.ctypes.data,
                        keys.ctypes.data, len(keys), m)
    np.testing.assert_array_equal(got[0], to_numpy(key))
    misses = int((got[0] < 0).sum())
    assert to_numpy(counts).tolist() == got[2].tolist() == [misses,
                                                            m - misses]
    cached = {r.tobytes() for r in keys}
    assert [r.tobytes() in cached for r in lanes] == (got[0] >= 0).tolist()
    hit = got[0] >= 0
    assert (keys[got[0][hit]] == lanes[hit]).all() and 0 < misses < m
    assert (got[0][-5:-1] >= 0).all() and got[0][-1] == -1
    np.testing.assert_array_equal(got[1][:misses], to_numpy(order)[:misses])
    np.testing.assert_array_equal(np.sort(got[1][misses:]),
                                  np.sort(to_numpy(order)[misses:]))


def _check_verify_init_host_random_keys(lib):
    """verify.cu's Verify_Init (the wide core) on 32 random keys from a
    seeded generator, about half of them off the curve, and the all-0xFF
    key: planes and flags equal to verify_init_plain's. Then poly.cu's and
    oneshot.cu's lanes on these keys: random digits, and the edge digits
    (u, v) = (0, 0), (255, 15), (0, 15) and (255, 0) in every place."""
    pk = np.random.default_rng(10).integers(0, 256, (33, 32), dtype=np.uint8)
    pk[32] = 0xFF
    planes = np.zeros((len(pk), 16, 160), np.int8)
    ok = np.zeros(len(pk), np.uint8)
    lib.verify_init_host(planes.ctypes.data, ok.ctypes.data, pk.ctypes.data,
                         len(pk))
    want_planes, want_ok = verify_kernel.verify_init_plain(t(pk))
    np.testing.assert_array_equal(planes, to_numpy(want_planes))
    np.testing.assert_array_equal(ok.astype(bool), to_numpy(want_ok))
    assert 8 <= ok[:32].sum() <= 24, ok
    rng = np.random.default_rng(11)
    u = fold.cut8_bytes(from_numpy(rng.integers(0, 256, (len(pk), 32),
                                                dtype=np.uint8)))
    v = fold.cut4_limbs(sc.from_digest(from_numpy(rng.integers(
        0, 256, (len(pk), 64), dtype=np.uint8))))
    u, v = to_numpy(u).copy(), to_numpy(v).copy()
    for lane, (du, dv) in enumerate(((0, 0), (255, 15), (0, 15), (255, 0))):
        u[lane], v[lane] = du, dv
    _check_poly_and_oneshot_host(lib, pk, u, v, planes, shared_lanes=(0, 32))
