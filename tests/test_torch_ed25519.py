"""The port's Ed25519 slice (keygen and sign, blinding) against the JAX
package's, byte for byte.

On the CPU the port's create_keypair and sign run the plain versions of the
fused keygen and sign kernels (ops/cuda/sign_kernel.py), and messages over
943 bytes the same composition; the JAX side runs its own CPU route,
jitted once per module. The g++ build of the kernels' lane code
(csrc/sign.cu) is held against the plain versions. refmodel and the RFC 8032
vectors carry the broad coverage. Ragged batches (sign_ragged) go through
the JAX package's bucketing code with the port's sign per bucket. The
custom tool's blinder source is held against the JAX tool's. Inputs come
from a seeded numpy generator. Tolerance: exact bytes (and exact limbs for
the contexts).
"""

import functools
import shutil

import numpy as np
import pytest
import torch

import jax

from curve25519_tpu import _custom_blind as jcb
from curve25519_tpu import refmodel
from curve25519_tpu.models import blinding as jblinding
from curve25519_tpu.models import ed25519 as jed25519
from curve25519_tpu.tools import custom_tool as jtool
from curve25519_tpu.utils import bucketing as jbucketing

from curve25519_tpu_torch import _custom_blind as tcb
from curve25519_tpu_torch.config import ELL
from curve25519_tpu_torch.models import blinding, ed25519, tables, x25519
from curve25519_tpu_torch.ops import sha512
from curve25519_tpu_torch.ops.cuda import build, edwards_kernel, sign_kernel
from curve25519_tpu_torch.parallel import mesh as pmesh
from curve25519_tpu_torch.tools import custom_tool
from curve25519_tpu_torch.utils import interop
from curve25519_tpu_torch.utils.interop import to_numpy

# the carriers default to the card: these tests ask for the CPU
blinding_from_jax = functools.partial(interop.blinding_from_jax, device="cpu")
from_numpy = functools.partial(interop.from_numpy, device="cpu")

# RFC 8032 7.1 TEST 1-3 (the constants of tests/test_ed25519.py)
VECS = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]

_jax_keypair = jax.jit(jed25519.create_keypair)
_jax_sign_blinded = jax.jit(
    lambda p, m, n, bl: jed25519.sign(p, m, n, blinding=bl))


@pytest.fixture(scope="module", autouse=True)
def _free_xla_executables():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(8032)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    return build.load_host(build.build_host(tmp_path_factory.mktemp("host")))


def rows(t):
    return [bytes(r) for r in to_numpy(t).reshape(-1, to_numpy(t).shape[-1])]


def oracle_sigs(priv, msg, lengths):
    return [refmodel.ed_sign(p.tobytes(), m[:n].tobytes())
            for p, m, n in zip(priv, msg, lengths)]


def test_static_blinder_constants_equal_jax(monkeypatch, tmp_path, capsys):
    for name in ("BL", "ZR_BYTES", "BP_X", "BP_Y"):
        assert getattr(tcb, name) == getattr(jcb, name), name
    _check_custom_tool(monkeypatch, tmp_path, capsys)


def _check_custom_tool(monkeypatch, tmp_path, capsys):
    """The blinder source that the tool writes equals the JAX tool's once
    the package names are the same; `t` passes on the CPU; `b` writes a
    module whose BP is -BL*G."""
    seed = np.random.default_rng(54).bytes(64)
    src = custom_tool.create_blinding_source(seed, device="cpu")
    assert src.replace("curve25519_tpu_torch", "curve25519_tpu") == \
        jtool.create_blinding_source(seed)
    assert custom_tool.cmd_testvector(b"seed", b"message", device="cpu") == 0
    assert "verified[native-sign] = True" in capsys.readouterr().out
    assert custom_tool.main([]) == 2
    out = tmp_path / "_custom_blind.py"          # never the package's file
    monkeypatch.setattr(custom_tool, "_BLIND_PATH", out)
    custom_tool.cmd_blind(device="cpu")
    ns = {}
    exec(out.read_text(), ns)
    assert refmodel.base_mult((ELL - ns["BL"]) % ELL) == (ns["BP_X"],
                                                          ns["BP_Y"])
    assert len(ns["ZR_BYTES"]) == 32


def test_blinding_init_equals_jax():
    jctx = jblinding.blinding_init(b"port")
    ctx = blinding.blinding_init(b"port", device="cpu")
    chained_j = jblinding.blinding_init(b"again", parent=jctx)
    chained = blinding.blinding_init(b"again", parent=ctx)
    for t, j in ((ctx, jctx), (chained, chained_j)):
        for k in ("bl", "zr", "zr_bytes"):
            np.testing.assert_array_equal(to_numpy(t[k]), np.asarray(j[k]))
        for k in ("ypx", "ymx", "t2d", "z2"):
            np.testing.assert_array_equal(to_numpy(t["bp"][k]),
                                          np.asarray(j["bp"][k]))
        for k in ("_b", "_zr_bytes", "_bp_point"):
            assert t[k] == j[k], k
    np.testing.assert_array_equal(to_numpy(blinding.default_zr(device="cpu")),
                                  np.asarray(jblinding.default_zr()))


def test_keypair_equals_jax(rng):
    sk = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    jpk, jpriv = _jax_keypair(sk)
    pk, priv = ed25519.create_keypair(from_numpy(sk))
    np.testing.assert_array_equal(to_numpy(pk), np.asarray(jpk))
    np.testing.assert_array_equal(to_numpy(priv), np.asarray(jpriv))


def test_sign_equals_jax(rng):
    """create_keypair, then sign (plain and blinded, one context carried
    across by blinding_from_jax), on messages of up to 1,000 bytes with a
    length per lane (the fused and the long-message lengths), against the
    JAX package's blinded sign on the same keys."""
    sk = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    _, priv = ed25519.create_keypair(from_numpy(sk))
    msg = rng.integers(0, 256, (3, 1000), dtype=np.uint8)
    lengths = np.array([0, 943, 1000], np.int32)
    jctx = jblinding.blinding_init(b"carried")
    want = np.asarray(_jax_sign_blinded(
        to_numpy(priv), msg, lengths, jblinding.as_batch(jctx, (3,))))
    ctx = blinding_from_jax(jctx)
    for bl in (None, ctx, blinding.as_batch(ctx, (3,))):
        got = ed25519.sign(priv, from_numpy(msg), from_numpy(lengths),
                           blinding=bl)
        np.testing.assert_array_equal(to_numpy(got), want)
    assert rows(got)[2] == refmodel.ed_sign(to_numpy(priv)[2].tobytes(),
                                            msg[2].tobytes())
    _check_mesh_sign(priv, msg, lengths, want)


def _check_mesh_sign(priv, msg, lengths, want):
    """sharded(sign) over two CPU devices on 4 lanes of fused lengths (the
    two such lanes above, twice): each device signs its shard, and the
    shards in mesh order are the JAX package's signatures (the port's
    counterpart of test_sharded_wrapper_matches_single_device)."""
    lanes = [0, 1, 0, 1]
    m = pmesh.make_mesh(["cpu", "cpu"])
    args = [pmesh.shard_batch(x, m) for x in (
        to_numpy(priv)[lanes], msg[lanes, :943], lengths[lanes])]
    assert sign_kernel.max_fused_msg_len(943)
    sig = pmesh.sharded(ed25519.sign, m)(*args)
    assert [s.shape for s in sig] == [(2, 64)] * 2
    np.testing.assert_array_equal(to_numpy(torch.cat(sig)), want[lanes])


def test_rfc8032_vectors_with_numpy_inputs_on_the_cpu():
    sks = np.stack([np.frombuffer(bytes.fromhex(v[0]), np.uint8)
                    for v in VECS])
    pk, priv = ed25519.create_keypair(sks, device="cpu")
    assert pk.device.type == "cpu"
    assert [r.hex() for r in rows(pk)] == [v[1] for v in VECS]
    msg = np.zeros((3, 8), np.uint8)
    lengths = [len(bytes.fromhex(v[2])) for v in VECS]
    for i, v in enumerate(VECS):
        msg[i, :lengths[i]] = np.frombuffer(bytes.fromhex(v[2]), np.uint8)
    sig = ed25519.sign(to_numpy(priv), msg, lengths, device="cpu")
    assert [r.hex() for r in rows(sig)] == [v[3] for v in VECS]
    if not torch.cuda.is_available():
        # non-tensor input, no device, no card: raise, never run on the CPU
        with pytest.raises(RuntimeError):
            ed25519.create_keypair(sks)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ed25519.sign_ragged(np.zeros(64, np.uint8), [b"ab"])
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ed25519.verify_ragged(np.zeros(64, np.uint8),
                                  np.zeros(32, np.uint8), [b"ab"])


def test_sign_routes_match_the_oracle(rng, monkeypatch):
    sk = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    _, priv = ed25519.create_keypair(from_numpy(sk))
    p = to_numpy(priv)
    short = rng.integers(0, 256, (4, 64), dtype=np.uint8)
    n_short = np.array([0, 1, 63, 64], np.int32)
    sig = ed25519.sign(priv, from_numpy(short), from_numpy(n_short))
    assert rows(sig) == oracle_sigs(p, short, n_short)
    assert sign_kernel.max_fused_msg_len(943)
    assert not sign_kernel.max_fused_msg_len(944)
    long = rng.integers(0, 256, (2, 1500), dtype=np.uint8)
    n_long = np.array([944, 1500], np.int32)
    sig = ed25519.sign(priv[:2], from_numpy(long), from_numpy(n_long))
    assert rows(sig) == oracle_sigs(p[:2], long, n_long)
    # rank-1 call == its batch row; one key broadcast over two messages
    one = ed25519.sign(priv[1], from_numpy(short[1]))
    assert rows(one) == [refmodel.ed_sign(p[1].tobytes(), short[1].tobytes())]
    bcast = ed25519.sign(priv[0], from_numpy(short[:2]))
    assert rows(bcast) == oracle_sigs(np.stack([p[0], p[0]]), short[:2],
                                      [64, 64])
    _check_sign_ragged(priv, rng, monkeypatch)


def _check_sign_ragged(priv, rng, monkeypatch):
    """sign_ragged of 4 messages in 2 buckets equals the oracle, the padded
    batch of the same rows, and the JAX package's sign_ragged and
    apply_bucketed driving the port's sign per bucket, with per-lane keys
    and with one key for all; a blinding context changes nothing."""
    p = to_numpy(priv)
    msgs = [rng.bytes(n) for n in (200, 5, 111, 150)]   # buckets 2, 1, 1, 2
    sig = ed25519.sign_ragged(priv, msgs)
    assert rows(sig) == [refmodel.ed_sign(p[i].tobytes(), m)
                         for i, m in enumerate(msgs)]
    padded = np.zeros((4, 200), np.uint8)
    for i, m in enumerate(msgs):
        padded[i, :len(m)] = np.frombuffer(m, np.uint8)
    lens = np.array([len(m) for m in msgs], np.int32)
    assert torch.equal(sig, ed25519.sign(priv, from_numpy(padded),
                                         from_numpy(lens)))
    ctx = blinding.blinding_init(b"ragged", device="cpu")
    assert torch.equal(ed25519.sign_ragged(priv, msgs, blinding=ctx), sig)

    def port_sign(m, l, pr):
        return to_numpy(ed25519.sign(*(from_numpy(np.ascontiguousarray(a))
                                       for a in (pr, m, l))))

    np.testing.assert_array_equal(
        jbucketing.apply_bucketed(port_sign, msgs, p), to_numpy(sig))
    # the JAX sign_ragged (its broadcast and buckets), the port's sign inside
    monkeypatch.setattr(jed25519, "_sign_jit", port_sign)
    np.testing.assert_array_equal(np.asarray(jed25519.sign_ragged(p, msgs)),
                                  to_numpy(sig))
    np.testing.assert_array_equal(
        np.asarray(jed25519.sign_ragged(p[0], msgs)),
        to_numpy(ed25519.sign_ragged(priv[0], msgs)))


def test_blinding_leaves_every_output_unchanged(rng):
    sk = from_numpy(rng.integers(0, 256, (3, 32), dtype=np.uint8))
    msg = from_numpy(rng.integers(0, 256, (3, 40), dtype=np.uint8))
    pk, priv = ed25519.create_keypair(sk)
    sig = ed25519.sign(priv, msg)
    host = blinding.blinding_init(b"device", device="cpu")
    ctx = blinding.blinding_init_device(b"device", device="cpu")
    for k in ("bl", "zr", "zr_bytes"):
        assert torch.equal(ctx[k], host[k]), k
    for k in host["bp"]:
        assert torch.equal(ctx["bp"][k], host["bp"][k]), k
    ctx["zr"] = blinding.fresh_zr(torch.Generator().manual_seed(1), (3,))
    assert torch.equal(ed25519.create_keypair(sk, blinding=ctx)[0], pk)
    assert torch.equal(ed25519.sign(priv, msg, blinding=ctx), sig)
    assert torch.equal(x25519.calculate_public_key_fast(sk, zr=ctx["zr"]),
                       x25519.calculate_public_key(sk))


def test_blinding_finish_zeroes_and_empties_the_context():
    ctx = blinding.blinding_init(b"finish", device="cpu")
    bl, ypx = ctx["bl"], ctx["bp"]["ypx"]
    assert bl.any() and ypx.any()
    blinding.blinding_finish(ctx)
    assert ctx == {} and not bl.any() and not ypx.any()
    with pytest.raises(KeyError):
        ed25519.create_keypair(torch.zeros(1, 32, dtype=torch.uint8),
                               blinding=ctx)


def test_mixed_devices_raise():
    sk = torch.zeros(2, 32, dtype=torch.uint8)
    ctx = blinding.blinding_init(b"meta", device="cpu")
    ctx["bl"] = ctx["bl"].to("meta")
    with pytest.raises(ValueError):
        ed25519.create_keypair(sk, blinding=ctx)
    with pytest.raises(ValueError):
        ed25519.sign(torch.zeros(2, 64, dtype=torch.uint8),
                     torch.zeros(2, 8, dtype=torch.uint8),
                     torch.zeros(2, dtype=torch.int32, device="meta"))


def test_host_kernels_equal_plain(lib, rng):
    """keygen_host (plain and blinded) with the masked scan and with the
    host emulation of keygen_kernel's tensor-core gather (mma = 1, lane i at
    position i % 32 of its warp), and sign_host, against the plain
    versions."""
    n = 4
    sk = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    ctx = blinding.blinding_init(b"host", device="cpu")
    dz = np.ascontiguousarray(to_numpy(blinding.default_zr(device="cpu")))
    zr, bl = (np.ascontiguousarray(to_numpy(ctx[k])) for k in ("zr", "bl"))
    bp = np.ascontiguousarray(to_numpy(torch.cat(
        [ctx["bp"][k] for k in edwards_kernel.PE_KEYS])))
    cpu = torch.device("cpu")
    table = to_numpy(edwards_kernel.packed_table(8, cpu))
    frag = to_numpy(edwards_kernel.mma_table(cpu))
    plain = sign_kernel.keygen_plain(from_numpy(sk),
                                     zr=blinding.default_zr(device="cpu"))
    for mma, tbl in ((0, table), (1, frag)):
        for args in ((dz, None, None), (zr, bl, bp)):
            pk = np.zeros((n, 32), np.uint8)
            z, b, q = (None if a is None else a.ctypes.data for a in args)
            lib.keygen_host(mma, pk.ctypes.data, sk.ctypes.data, z, 0, b, 0,
                            q, 0, tbl.ctypes.data, n)
            np.testing.assert_array_equal(
                pk, to_numpy(plain), err_msg="mma=%d blinded=%s"
                % (mma, args[1] is not None))

    priv = np.concatenate([sk, pk], 1)
    msg = rng.integers(0, 256, (n, 200), dtype=np.uint8)
    lengths = np.array([0, 64, 111, 200], np.int32)
    packed = [sha512.pack_words(from_numpy(msg), from_numpy(lengths),
                                prefix=torch.zeros(n, h, dtype=torch.uint8))
              for h in (32, 64)]
    (w2, nb2), (w3, nb3) = ((np.ascontiguousarray(to_numpy(w)),
                             np.ascontiguousarray(to_numpy(nb)))
                            for w, nb, _ in packed)
    want = sign_kernel.sign_plain(from_numpy(priv), from_numpy(msg),
                                  from_numpy(lengths),
                                  zr=blinding.default_zr(device="cpu"))
    assert rows(want) == oracle_sigs(priv, msg, lengths)
    for args in ((dz, None, None), (zr, bl, bp)):
        sig = np.zeros((n, 64), np.uint8)
        z, b, q = (None if a is None else a.ctypes.data for a in args)
        lib.sign_host(sig.ctypes.data, priv.ctypes.data, w2.ctypes.data,
                      w2.shape[1], nb2.ctypes.data, w3.ctypes.data,
                      w3.shape[1], nb3.ctypes.data, z, 0, b, 0, q, 0,
                      table.ctypes.data, n)
        np.testing.assert_array_equal(sig, to_numpy(want))


def test_host_tensor_core_gather_equals_scan(lib):
    """The host emulation of the sign kernel's tensor-core gather (the A, B
    and D fragment layouts of mma.m16n8k32 over edwards_kernel.mma_table,
    csrc/gather_mma.cuh) against the masked scan gather<256> over the packed
    table, and both against the table's rows: digits 0 and 255, all equal,
    all distinct, and a partial warp."""
    cpu = torch.device("cpu")
    packed = to_numpy(edwards_kernel.packed_table(8, cpu))
    frag = to_numpy(edwards_kernel.mma_table(cpu))
    limbs = tables.folding8_table().reshape(256, 60)
    perm = np.random.default_rng(3).permutation(256).astype(np.int32)
    cases = {"0 and 255": np.tile(np.array([0, 255], np.int32), 16),
             "all equal": np.full(32, 77, np.int32),
             "all distinct": perm,
             "partial warp": np.concatenate([perm[:32], perm[:13]])}
    for name, dig in cases.items():
        want = limbs[dig]
        for mma, table in ((0, packed), (1, frag)):
            out = np.full((len(dig), 60), -1, np.int32)
            lib.gather_host(mma, out.ctypes.data, dig.ctypes.data,
                            table.ctypes.data, len(dig))
            np.testing.assert_array_equal(out, want, err_msg="%s mma=%d"
                                          % (name, mma))
