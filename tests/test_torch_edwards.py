"""The port's folding tables, Edwards point arithmetic and base multiply
against the JAX package's, and the g++ build of the base-multiply kernel's
lane code (csrc/basemult.cu) against the port's plain version.

Point ops and the fold-8 and fold-4 multiplies must give equal limbs (same
radix, same op order); every epilogue must give the bytes of the
Python-integer oracle (curve25519_tpu.refmodel) and of the X25519 ladder.
The fold-4 byte modes run on the wide field core in the kernel; their lane
is held byte for byte against the plain version, on random and edge
digits. Inputs come from a seeded numpy generator. Tolerance: exact.
"""

import functools
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curve25519_tpu import refmodel
from curve25519_tpu.models import blinding as jblinding
from curve25519_tpu.models import edwards as jedwards
from curve25519_tpu.models import tables as jtables
from curve25519_tpu.models import x25519 as jx25519
from curve25519_tpu.ops import fold as jfold

from curve25519_tpu_torch.config import ELL, P, int_to_limbs, limbs_to_int
from curve25519_tpu_torch.models import blinding, edwards, tables, x25519
from curve25519_tpu_torch.ops import codec, fold
from curve25519_tpu_torch.ops.cuda import build, edwards_kernel
from curve25519_tpu_torch.utils import interop
from curve25519_tpu_torch.utils.interop import to_numpy

# the carriers default to the card: these tests ask for the CPU
blinding_from_jax = functools.partial(interop.blinding_from_jax, device="cpu")
from_numpy = functools.partial(interop.from_numpy, device="cpu")

COORDS = ("x", "y", "z", "t")


@pytest.fixture(scope="module", autouse=True)
def _free_xla_executables():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(8032)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    return build.load_host(build.build_host())


def rand_keys(rng, n):
    return rng.integers(0, 256, (n, 32), dtype=np.uint8)


def rand_point(rng, n):
    """Ext points (X : Y : Z : T) of multiples of G with a random Z."""
    pts = [refmodel.base_mult(int(k)) for k in rng.integers(1, 2**62, n)]
    zs = [int.from_bytes(rng.bytes(32), "little") % P or 1 for _ in range(n)]
    arr = {c: np.stack([int_to_limbs(v % P) for v in vals]) for c, vals in (
        ("x", [x * z for (x, _), z in zip(pts, zs)]),
        ("y", [y * z for (_, y), z in zip(pts, zs)]),
        ("z", zs),
        ("t", [x * y * z for (x, y), z in zip(pts, zs)]))}
    return arr


def test_tables_and_gathers_equal_jax(rng):
    np.testing.assert_array_equal(tables.folding8_table(),
                                  np.asarray(jtables.folding8_table()))
    np.testing.assert_array_equal(tables.folding4_table(),
                                  np.asarray(jtables.folding4_table()))
    for nent, gather, jgather in ((256, tables.gather_pa, jtables.gather_pa),
                                  (16, tables.gather_pa4,
                                   jtables.gather_pa4)):
        idx = np.concatenate([[0, nent - 1], rng.integers(0, nent, 14)])
        idx = idx.astype(np.int32).reshape(2, 8)
        got, want = gather(from_numpy(idx)), jgather(jnp.asarray(idx))
        for k in ("ypx", "ymx", "t2d"):
            np.testing.assert_array_equal(to_numpy(got[k]), np.asarray(want[k]))
    # the kernels' packed layout holds the same limbs
    packed = to_numpy(edwards_kernel.packed_table(8, torch.device("cpu")))
    packed = packed.reshape(256, 32)[:, :30]
    flat = tables.folding8_table().reshape(256, 60)
    np.testing.assert_array_equal(packed & 0xFFFF, flat[:, 0::2])
    np.testing.assert_array_equal(packed >> 16, flat[:, 1::2])
    _check_word_table()


def _check_word_table():
    """word_table, the wide lanes' layout (fold 4's byte modes, verify's
    double-scalar multiply with fold 8): entry e's words 8c..8c+7 are the
    little-endian words of coordinate c's value in the folding table, each
    below p."""
    for nfolds, table in ((4, tables.folding4_table()),
                          (8, tables.folding8_table())):
        words = to_numpy(edwards_kernel.word_table(nfolds,
                                                   torch.device("cpu")))
        words = words.view(np.uint32).reshape(len(table), 3, 8)
        for entry, limbs in zip(words, table):
            for w, c in zip(entry, limbs):
                value = sum(int(v) << 32 * k for k, v in enumerate(w))
                assert value == limbs_to_int(c) < P, nfolds


@pytest.mark.parametrize("op", ["double", "add_pe", "add_pa"])
def test_point_ops_limbs_equal_jax(rng, op):
    p, q = rand_point(rng, 6), rand_point(rng, 6)
    tp = {c: from_numpy(p[c]) for c in COORDS}
    jp = {c: jnp.asarray(p[c]) for c in COORDS}
    if op == "double":
        got, want = edwards.double(tp), jedwards.double(jp)
    elif op == "add_pe":
        tq = edwards.to_pe({c: from_numpy(q[c]) for c in COORDS})
        jq = jedwards.to_pe({c: jnp.asarray(q[c]) for c in COORDS})
        for k in tq:
            np.testing.assert_array_equal(to_numpy(tq[k]), np.asarray(jq[k]))
        got, want = edwards.add_pe(tp, tq), jedwards.add_pe(jp, jq)
    else:
        pa = tables.folding8_table()[rng.integers(0, 256, 6)]
        keys = ("ypx", "ymx", "t2d")
        got = edwards.add_pa(tp, {k: from_numpy(pa[:, i])
                                  for i, k in enumerate(keys)})
        want = jedwards.add_pa(jp, {k: jnp.asarray(pa[:, i])
                                    for i, k in enumerate(keys)})
    for c in COORDS:
        np.testing.assert_array_equal(to_numpy(got[c]), np.asarray(want[c]))


def test_fold8_base_mult_limbs_equal_jax(rng):
    """S = a*G with a context's zr and BP added, limb for limb, on the JAX
    package's eager fold-8 multiply; the context crosses by
    blinding_from_jax."""
    jctx = jblinding.blinding_init(b"edwards")
    ctx = blinding_from_jax(jctx)
    sk = rand_keys(rng, 3)
    cut = fold.cut8_bytes(from_numpy(sk))
    got = edwards.add_pe(edwards.base_point_mult(cut, zr=ctx["zr"]), ctx["bp"])
    want = jedwards.add_pe(
        jedwards.base_point_mult(jfold.cut8_bytes(sk), zr=jctx["zr"]),
        jctx["bp"])
    for c in COORDS:
        np.testing.assert_array_equal(to_numpy(got[c]), np.asarray(want[c]))
    _check_fold4_base_mult_equals_jax(sk, ctx, jctx)


def _check_fold4_base_mult_equals_jax(sk, ctx, jctx):
    """The fold-4 multiply with zr and BP added, limb for limb, against the
    JAX package's eager base_point_mult_fold4; calculate_public_key_fast
    with nfolds=4, as an API user calls it, byte for byte against the JAX
    function."""
    cut = fold.cut4_bytes(from_numpy(sk))
    got = edwards.add_pe(edwards.base_point_mult_fold4(cut, zr=ctx["zr"]),
                         ctx["bp"])
    want = jedwards.add_pe(
        jedwards.base_point_mult_fold4(jfold.cut4_bytes(sk), zr=jctx["zr"]),
        jctx["bp"])
    for c in COORDS:
        np.testing.assert_array_equal(to_numpy(got[c]), np.asarray(want[c]))
    np.testing.assert_array_equal(
        to_numpy(x25519.calculate_public_key_fast(from_numpy(sk), nfolds=4)),
        np.asarray(jx25519.calculate_public_key_fast(sk, nfolds=4)))


@pytest.mark.parametrize("nfolds", [8, 4])
def test_plain_modes_match_the_oracle(rng, nfolds):
    sk = rand_keys(rng, 4)
    sk[0] = 0
    ctx = blinding.blinding_init(b"modes", device="cpu")
    cut = (fold.cut8_bytes if nfolds == 8 else fold.cut4_bytes)(
        torch.from_numpy(sk))
    raw = [int.from_bytes(k.tobytes(), "little") for k in sk]
    pts = [refmodel.base_mult(a) for a in raw]
    x, y = edwards_kernel.base_mult_plain(cut, zr=ctx["zr"], mode="affine",
                                          nfolds=nfolds)
    assert [(limbs_to_int(a) % P, limbs_to_int(b) % P)
            for a, b in zip(to_numpy(x), to_numpy(y))] == pts
    pk = edwards_kernel.base_mult_plain(cut, mode="pk", nfolds=nfolds)
    assert [bytes(r) for r in to_numpy(pk)] == [refmodel.compress(p)
                                                for p in pts]
    u, u2 = edwards_kernel.base_mult_plain(cut, mode="mont_u", nfolds=nfolds)
    assert torch.equal(u, u2)
    ub = edwards_kernel.base_mult_plain(cut, zr=ctx["zr"], mode="u_bytes",
                                        nfolds=nfolds)
    assert [limbs_to_int(r) % P for r in to_numpy(u)] == [
        int.from_bytes(bytes(r), "little") for r in to_numpy(ub)]
    # the blinding point BP = b*G is added: (a + bl)*G + BP = a*G
    bl = limbs_to_int(to_numpy(ctx["bl"]))
    cut_bl = (fold.cut8_limbs if nfolds == 8 else fold.cut4_limbs)(
        torch.stack([torch.as_tensor(int_to_limbs((a + bl) % ELL))
                     for a in raw]))
    pk_bl = edwards_kernel.base_mult_plain(cut_bl, zr=ctx["zr"], bp=ctx["bp"],
                                           mode="pk", nfolds=nfolds)
    assert torch.equal(pk_bl, pk)


def test_calculate_public_key_fast_equals_ladder(rng):
    sk = torch.from_numpy(rand_keys(rng, 6))
    ladder = x25519.calculate_public_key(sk)
    zr = blinding.fresh_zr(torch.Generator().manual_seed(5), (6,))
    for nfolds in (8, 4):
        assert torch.equal(x25519.calculate_public_key_fast(sk, nfolds=nfolds),
                           ladder)
        assert torch.equal(x25519.calculate_public_key_fast(
            sk, zr=zr, nfolds=nfolds), ladder)
    assert [bytes(r) for r in to_numpy(ladder)] == [
        refmodel.x25519_base(bytes(r)) for r in to_numpy(sk)]
    with pytest.raises(ValueError):
        x25519.calculate_public_key_fast(sk, nfolds=6)


def host_basemult(lib, cut, zr, bp, mode, nfolds, mma=False):
    """basemult.cu's lane code built with g++ on the table and lane that its
    kernel launch reads (edwards_kernel.kernel_table: the wide lane for the
    byte modes, the 13-bit lane for the limb modes); fold 8 by the masked
    scan of the word table, or (mma) the host emulation of the tensor-core
    gather over its B-order layout."""
    n = len(cut)
    cut = np.ascontiguousarray(cut, np.int32)
    cpu = torch.device("cpu")
    table = to_numpy(edwards_kernel.word_table(8, cpu) if nfolds == 8
                     and not mma
                     else edwards_kernel.kernel_table(nfolds, mode, cpu))
    byte_mode = mode in ("pk", "u_bytes")
    out = np.zeros((n, 32), np.uint8) if byte_mode else np.zeros((n, 40),
                                                                 np.int32)
    rc = lib.basemult_host(
        int(mma), out.ctypes.data, cut.ctypes.data,
        None if zr is None else zr.ctypes.data, 0,
        None if bp is None else bp.ctypes.data, 0, table.ctypes.data, nfolds,
        edwards_kernel.MODES[mode], n)
    assert rc == 0
    return out if byte_mode else (out[:, :20], out[:, 20:])


@pytest.mark.parametrize("nfolds, mma", [
    pytest.param(8, False, id="8"), pytest.param(4, False, id="4"),
    pytest.param(8, True, id="8-mma")])
def test_host_kernel_equals_plain(lib, rng, nfolds, mma):
    """Every mode, with and without BP: the byte modes on the wide lane, the
    limb modes on the 13-bit lane (fold 8's through the canonical words of
    the same gather). The tensor-core gather's emulation (the lane's digit at
    its own position in a warp whose other lanes ask for other entries) runs
    on 3 lanes at positions 0, 1, 2 and is also held against the masked
    scan. Fold 4 (the byte modes on the wide lane) also
    runs without zr, and on edge digits: all 0 (the identity: u_bytes 0, pk
    enc(0, 1)), all 15, and the clamped key of 32 0xFF bytes, whose top
    digit is set."""
    sk = torch.from_numpy(rand_keys(rng, 3))
    cut = (fold.cut8_bytes if nfolds == 8 else fold.cut4_bytes)(sk)
    if nfolds == 4:
        top = fold.cut4_bytes(codec.clamp(torch.full((1, 32), 255,
                                                     dtype=torch.uint8)))
        assert top[0, -1] != 0
        cut = torch.cat([cut, torch.zeros_like(cut[:1]),
                         torch.full_like(cut[:1], 15), top])
    ctx = blinding.blinding_init(b"host", device="cpu")
    zr = np.ascontiguousarray(to_numpy(ctx["zr"]))
    bp = np.ascontiguousarray(to_numpy(torch.cat(
        [ctx["bp"][k] for k in edwards_kernel.PE_KEYS])))
    outs = {}
    for mode in edwards_kernel.MODES:
        for use_zr in (True, False) if nfolds == 4 else (True,):
            for use_bp in (False, True):
                got = host_basemult(lib, to_numpy(cut), zr if use_zr else None,
                                    bp if use_bp else None, mode, nfolds, mma)
                want = edwards_kernel.base_mult_plain(
                    cut, zr=ctx["zr"] if use_zr else None,
                    bp=ctx["bp"] if use_bp else None, mode=mode,
                    nfolds=nfolds)
                if isinstance(want, tuple):
                    for g, w in zip(got, want):
                        np.testing.assert_array_equal(g, to_numpy(w))
                else:
                    np.testing.assert_array_equal(got, to_numpy(want))
                outs[mode, use_zr, use_bp] = got
                if mma:
                    scan = host_basemult(lib, to_numpy(cut), zr,
                                         bp if use_bp else None, mode, nfolds)
                    for g, w in zip(
                            got if isinstance(got, tuple) else (got,),
                            scan if isinstance(scan, tuple) else (scan,)):
                        np.testing.assert_array_equal(g, w)
    if nfolds == 4:
        identity = 3
        assert not outs["u_bytes", True, False][identity].any()
        assert outs["pk", True, False][identity].tolist() == [1] + [0] * 31
        # zr scales the projective point only: the bytes stay as they are
        for mode in ("pk", "u_bytes"):
            np.testing.assert_array_equal(outs[mode, True, False],
                                          outs[mode, False, False])
    assert lib.basemult_host(1, None, None, None, 0, None, 0, None, 4, 0,
                             0) == -1           # the emulation is fold 8 only
