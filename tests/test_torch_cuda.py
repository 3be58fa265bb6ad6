"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card and nvcc, is marked `cuda`, and skips
where torch.cuda.is_available() is false. The file imports no jax, so it also
runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

This is the one home of the byte-equality checks on the card: every
kernel against its plain version on CHECK_LANES lanes or more, at every
RAGGED size, rank-1 and broadcast; the known answers of RFC 7748, RFC 8032
and hashlib; the 16 edge encodings; the paths and the ragged batches with
their launch counts. Oracles: portbench/reference/curve.py (Python
integers) and the JAX package's refmodel. Tolerance: exact bytes.
"""

import hashlib
from collections import Counter

import numpy as np
import pytest
import torch

from curve25519_tpu import refmodel
from curve25519_tpu.config import P
from portbench.reference import curve

from curve25519_tpu_torch.config import ELL, int_to_limbs
from curve25519_tpu_torch.models import blinding, ed25519, montgomery, x25519
from curve25519_tpu_torch.ops import codec, fold, sc, sha512
from curve25519_tpu_torch.ops.cuda import (
    edwards_kernel, ladder_kernel, sha512_kernel, sign_kernel, verify_kernel,
)
from curve25519_tpu_torch.utils import bucketing, profiling

pytestmark = pytest.mark.cuda

CHECK_LANES = 4096            # the least lanes of each kernel == plain check
ORACLE_LANES = 4              # random lanes held against the Python oracle
# ragged batch sizes: one lane, partial warps (31, 33), partial blocks
RAGGED = (1, 31, 33, 127, 129, 1000)
RAGGED_MSGS = 65_536          # sign_ragged / verify_ragged: 0-1,200 bytes
RAGGED_MAX = 1200

# RFC 7748 5.2 and 6.1 vectors (the constants of tests/test_x25519.py) and
# the x25519_edge_u values of benchmarks/tpu_vectors.py
V1_K = "a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4"
V1_U = "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c"
V1_OUT = "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"
V2_K = "4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d"
V2_U = "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493"
V2_OUT = "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"
A_SK = "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"
A_PK = "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
B_SK = "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb"
B_PK = "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
SHARED = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
EDGE_U = [0, 1, P, P + 1, 2**255 - 1, 1 | 1 << 255]

# RFC 8032 7.1 TEST 1-3 (sk, pk, msg, sig), the constants of
# tests/test_ed25519.py
ED_VECS = [
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
SHA_LENGTHS = [0, 1, 111, 112, 127, 128, 129, 239, 240]
# keys that decode specially: y = 0, 1, p, p + 1 (small order, non-canonical)
# with and without the sign bit; y = 2 and 2^255 - 1 (off the curve)
EDGE_PK = [0, 1, 2, P, P + 1, 2**255 - 1, 1 | 1 << 255, P | 1 << 255]
# S at l's edges (the digits kernel cuts S's raw bytes, never reduced)
EDGE_S = [0, ELL - 1, ELL, ELL + 1, 2 * ELL, ELL + 2**200, 2**255,
          2**256 - 1]
EDGE_MSG = b"edge vector msg!"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def rng():
    return np.random.default_rng(90)


def on(dev, arr):
    return torch.from_numpy(np.array(arr)).to(dev)


def rand_u8(dev, rng, *shape):
    return on(dev, rng.integers(0, 256, shape, dtype=np.uint8))


def hex_rows(dev, values):
    return on(dev, np.stack([np.frombuffer(bytes.fromhex(v), np.uint8)
                             for v in values]))


def le_rows(dev, values):
    return on(dev, np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                             for v in values]))


def row(t):
    return bytes(t.cpu().tolist())


def same(got, want):
    """Equal tensors, or equal tuples of tensors."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(torch.equal(g, w)
                                         for g, w in zip(got, want))


def rows_of(want, n):
    return tuple(w[:n] for w in want) if isinstance(want, tuple) else want[:n]


def _launches():
    """Every hand-written kernel's launch count, by kernel."""
    got = {"ladder": ladder_kernel.launches,
           "basemult": edwards_kernel.launches,
           "sha512": sha512_kernel.launches,
           "pack_words": sha512_kernel.pack_launches}
    got.update(sign_kernel.launches)
    got.update(verify_kernel.launches)
    return got


def _launched(fn, *args, **kw):
    """(fn's output, the launches it made by kernel, kernels it did not
    launch left out)."""
    before = _launches()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    after = _launches()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def test_kernel_equals_plain(dev, rng):
    n = CHECK_LANES + 37                           # not a multiple of a block
    sk = rand_u8(dev, rng, n, 32)
    peer = rand_u8(dev, rng, n, 32)
    zr = on(dev, np.stack([int_to_limbs(int.from_bytes(rng.bytes(32), "little")
                                        % P or 1) for _ in range(n)]))
    before = ladder_kernel.launches
    products = dict(ladder_kernel.pipe_products)
    got = x25519.create_shared_key(peer, sk)
    torch.cuda.synchronize()
    assert ladder_kernel.launches == before + 1
    # the launch added its lanes times the library's per-lane products
    lane = ladder_kernel.lane_products()
    assert lane["fp64"] > 0 and lane["int"] > 0
    assert {k: v - products[k] for k, v in
            ladder_kernel.pipe_products.items()} == {
        k: n * lane[k] for k in ("fp64", "int")}
    assert torch.equal(got, montgomery.point_multiply(peer, sk))
    # a nonzero zr changes no byte, of the kernel or of the plain version
    assert torch.equal(x25519.create_shared_key(peer, sk, zr=zr), got)
    assert torch.equal(montgomery.point_multiply(peer[:256], sk[:256],
                                                 zr=zr[:256]), got[:256])
    # the all-zero peer (a low-order point) gives the all-zero secret
    assert not x25519.create_shared_key(torch.zeros_like(peer[:64]),
                                        sk[:64]).any()
    for m in RAGGED:
        assert torch.equal(x25519.create_shared_key(peer[:m], sk[:m]),
                           got[:m]), m
    assert torch.equal(x25519.create_shared_key(peer[7], sk[7]), got[7])
    bcast = x25519.create_shared_key(peer[0], sk[:16])
    assert bcast.shape == (16, 32)
    assert torch.equal(bcast, montgomery.point_multiply(peer[0], sk[:16]))


def test_kernel_known_answers(dev, rng):
    k = on(dev, np.frombuffer(bytes.fromhex(V1_K), np.uint8))
    u = on(dev, np.frombuffer(bytes.fromhex(V1_U), np.uint8))
    assert row(x25519.create_shared_key(u, k)).hex() == V1_OUT
    out = x25519.create_shared_key(hex_rows(dev, [V1_U, V2_U]),
                                   hex_rows(dev, [V1_K, V2_K]))
    assert [row(r).hex() for r in out] == [V1_OUT, V2_OUT]
    sks = hex_rows(dev, [A_SK, B_SK])
    pks = x25519.calculate_public_key(sks)
    assert [row(r).hex() for r in pks] == [A_PK, B_PK]
    assert torch.equal(x25519.calculate_public_key_fast(sks), pks)
    shared = x25519.create_shared_key(pks.flip(0), sks)
    assert [row(r).hex() for r in shared] == [SHARED, SHARED]

    peers = le_rows(dev, EDGE_U)
    sk7 = torch.full((len(EDGE_U), 32), 7, dtype=torch.uint8, device=dev)
    got = x25519.create_shared_key(peers, sk7)
    assert torch.equal(got, montgomery.point_multiply(peers, sk7))
    for r, v in zip(got.cpu().numpy(), EDGE_U):
        assert r.tobytes() == refmodel.x25519(b"\x07" * 32,
                                              v.to_bytes(32, "little"))

    sk = rng.integers(0, 256, (ORACLE_LANES, 32), dtype=np.uint8)
    peer = rng.integers(0, 256, (ORACLE_LANES, 32), dtype=np.uint8)
    got = x25519.create_shared_key(on(dev, peer), on(dev, sk))
    for i in range(ORACLE_LANES):
        assert row(got[i]) == curve.x25519(sk[i].tobytes(),
                                           peer[i].tobytes()), i


def test_kernel_rejects_mixed_devices(dev):
    sk = torch.zeros(2, 32, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        x25519.create_shared_key(torch.zeros(2, 32, dtype=torch.uint8), sk)


def test_numpy_inputs_land_on_the_card(dev, rng):
    sk = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    peer = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    before = ladder_kernel.launches
    got = x25519.create_shared_key(peer, sk)
    torch.cuda.synchronize()
    assert got.is_cuda and ladder_kernel.launches == before + 1
    assert torch.equal(got.cpu(), x25519.create_shared_key(peer, sk,
                                                           device="cpu"))
    _check_oo_card_route_equals_host_core(rng)


@pytest.mark.parametrize("nfolds", [8, 4])
def test_basemult_kernel_equals_plain(dev, rng, nfolds):
    sk = rand_u8(dev, rng, CHECK_LANES, 32)
    cut = (fold.cut8_bytes if nfolds == 8 else fold.cut4_bytes)(sk)
    ctx = blinding.blinding_init(b"cuda", device=dev)
    for mode in edwards_kernel.MODES:
        for bp in (None, ctx["bp"]):
            before = edwards_kernel.launches
            got = edwards_kernel.base_mult(cut, zr=ctx["zr"], bp=bp, mode=mode,
                                           nfolds=nfolds)
            want = edwards_kernel.base_mult_plain(cut, zr=ctx["zr"], bp=bp,
                                                  mode=mode, nfolds=nfolds)
            torch.cuda.synchronize()
            assert edwards_kernel.launches == before + 1
            assert same(got, want), mode
            # partial warps and blocks: fold 8's warp-wide gather, fold 4's
            # lane mask
            for n in RAGGED:
                assert same(edwards_kernel.base_mult(
                    cut[:n], zr=ctx["zr"], bp=bp, mode=mode, nfolds=nfolds),
                    rows_of(want, n)), (mode, bp is not None, n)
    assert torch.equal(x25519.calculate_public_key_fast(sk, nfolds=nfolds),
                       x25519.calculate_public_key(sk))
    if nfolds == 4:
        _check_fold4_edge_digits(dev, ctx)
    else:
        zr = blinding.default_zr(device=dev)
        full = edwards_kernel.base_mult(cut, zr=zr, mode="pk")
        assert torch.equal(edwards_kernel.base_mult(cut[5], zr=zr, mode="pk"),
                           full[5])
        assert torch.equal(edwards_kernel.base_mult(
            cut[:16], zr=ctx["zr"][None, :], mode="pk"), full[:16])


def _check_fold4_edge_digits(dev, ctx):
    """Fold 4 on its edge digits, every mode: all 0 (the identity, whose u
    is 0), all 15, and the clamped key of 32 0xFF bytes."""
    edge = torch.stack([torch.zeros(64, dtype=torch.int32, device=dev),
                        torch.full((64,), 15, dtype=torch.int32, device=dev),
                        fold.cut4_bytes(codec.clamp(torch.full(
                            (32,), 0xFF, dtype=torch.uint8, device=dev)))])
    for mode in edwards_kernel.MODES:
        assert same(edwards_kernel.base_mult(edge, zr=ctx["zr"], mode=mode,
                                             nfolds=4),
                    edwards_kernel.base_mult_plain(edge, zr=ctx["zr"],
                                                   mode=mode, nfolds=4)), mode
    assert not edwards_kernel.base_mult(edge[:1], mode="u_bytes",
                                        nfolds=4).any()


def test_sha512_kernel_equals_plain_and_hashlib(dev, rng):
    msg = rng.integers(0, 256, (9, 240), dtype=np.uint8)
    lengths = np.array(SHA_LENGTHS, np.int32)
    before = sha512_kernel.launches
    got = sha512.sha512(on(dev, msg), on(dev, lengths))
    assert sha512_kernel.launches == before + 1
    counts = sha512_kernel.launches, sha512_kernel.pack_launches
    assert torch.equal(got, sha512.sha512_plain(on(dev, msg), on(dev, lengths)))
    # the reference launches neither hand-written kernel
    assert (sha512_kernel.launches, sha512_kernel.pack_launches) == counts
    assert [bytes(r) for r in got.cpu().numpy()] == [
        hashlib.sha512(m[:n].tobytes()).digest() for m, n in zip(msg, lengths)]
    _check_sha512_batch(dev, rng)
    _check_pack_kernel(dev, rng)


def _check_sha512_batch(dev, rng, lanes=CHECK_LANES):
    """The packing and SHA-512 kernels against their plain versions on
    random lengths with the padding edges at the front, with and without a
    32-byte prefix; ragged, rank-1, and one prefix broadcast over 64
    messages."""
    msg = rand_u8(dev, rng, lanes, 240)
    lengths = rng.integers(0, 241, lanes).astype(np.int32)
    lengths[:len(SHA_LENGTHS)] = SHA_LENGTHS
    lengths = on(dev, lengths)
    prefix = rand_u8(dev, rng, lanes, 32)
    for pre in (None, prefix):
        assert same(sha512.pack_words(msg, lengths, pre)[:2],
                    sha512.pack_words_plain(msg, lengths, pre)[:2])
        got = sha512.sha512(msg, lengths, prefix=pre)
        assert torch.equal(got, sha512.sha512_plain(msg, lengths, prefix=pre))
        for n in RAGGED:
            assert torch.equal(sha512.sha512(
                msg[:n], lengths[:n], prefix=None if pre is None else pre[:n]),
                got[:n]), n
    assert torch.equal(sha512.sha512(msg[7, :int(lengths[7])]),
                       sha512.sha512_plain(msg[7:8], lengths[7:8])[0])
    assert torch.equal(sha512.sha512(msg[:64], lengths[:64], prefix=prefix[0]),
                       sha512.sha512_plain(msg[:64], lengths[:64],
                                           prefix=prefix[0]))


def _check_pack_kernel(dev, rng):
    """The packing kernel's (words, nblocks) equal the plain version's at a
    packet batch (165,000 rows of 1,167 bytes, contiguous and 1 byte off a
    1,168-byte stride, behind a 64-byte prefix and none) and at the TLS
    shapes (262,144 rows of 130 bytes behind 32- and 64-byte zero holes
    broadcast from one row); pack_launches counts 1 a pack_words, 2 a fused
    sign and 1 a verify."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1167)

    def rand(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8)

    def hold(msg, lengths, prefix):
        before = sha512_kernel.pack_launches
        got = sha512.pack_words(msg, lengths, prefix)
        assert sha512_kernel.pack_launches == before + 1
        want = sha512.pack_words_plain(msg, lengths, prefix)
        assert got[2] == want[2]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    n, max_len = 165_000, 1167
    wide = rand(n, max_len + 1)
    lengths = torch.randint(0, max_len + 1, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[:7] = torch.tensor([0, 1, 111, 112, 239, 240, max_len])
    for msg in (wide[:, :max_len].contiguous(), wide[:, 1:]):
        hold(msg, lengths, rand(n, 64))
        hold(msg, lengths, None)
    del wide, msg
    n, max_len = 262_144, 130
    msg = rand(n, max_len)
    lengths = torch.randint(0, max_len + 1, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    for plen in (32, 64):
        hold(msg, lengths, msg.new_zeros(1, plen).expand(n, plen))

    pk, priv = ed25519.create_keypair(on(dev, rng.integers(0, 256, (33, 32),
                                                            dtype=np.uint8)))
    msg, lengths = msg[:33], lengths[:33]
    before = sha512_kernel.pack_launches
    sig = sign_kernel.sign_fused(priv, msg, lengths)
    assert sha512_kernel.pack_launches == before + 2
    assert bool(ed25519.verify(sig, pk, msg, lengths).all())
    assert sha512_kernel.pack_launches == before + 3
    torch.cuda.synchronize()


def test_keygen_and_sign_kernels_equal_plain(dev, rng):
    n = CHECK_LANES
    sk = rand_u8(dev, rng, n, 32)
    ctx = blinding.blinding_init(b"cuda", device=dev)
    zr = blinding.default_zr(device=dev)
    before = dict(sign_kernel.launches)
    pk, priv = ed25519.create_keypair(sk)
    assert torch.equal(pk, sign_kernel.keygen_plain(sk, zr=zr))
    assert torch.equal(ed25519.create_keypair(sk, blinding=ctx)[0], pk)
    msg = rand_u8(dev, rng, n, 943)
    lengths = rng.integers(0, 944, n).astype(np.int32)
    lengths[:2] = 0, 943                           # the fused cap
    lengths = on(dev, lengths)
    sig = ed25519.sign(priv, msg, lengths)
    assert torch.equal(sig, sign_kernel.sign_plain(priv, msg, lengths, zr=zr))
    assert torch.equal(ed25519.sign(priv, msg, lengths, blinding=ctx), sig)
    assert sign_kernel.launches == {"keygen": before["keygen"] + 2,
                                    "sign": before["sign"] + 2}
    _check_keygen_and_sign_shapes(dev, rng, ctx, sk, pk, priv, msg, lengths,
                                  sig)
    # a message over 943 bytes takes the SHA-512 and base-multiply kernels
    long = on(dev, rng.integers(0, 256, (4, 2000), dtype=np.uint8))
    n_long = on(dev, np.array([944, 1000, 1500, 2000], np.int32))
    before = (sha512_kernel.launches, edwards_kernel.launches)
    got = ed25519.sign(priv[:4], long, n_long)
    assert (sha512_kernel.launches, edwards_kernel.launches) == (
        before[0] + 3, before[1] + 1)
    assert [bytes(r) for r in got.cpu().numpy()] == [
        refmodel.ed_sign(bytes(p.cpu().tolist()), bytes(m[:n].cpu().tolist()))
        for p, m, n in zip(priv[:4], long, n_long.tolist())]
    _check_ed25519_known_answers(dev, rng)


def _check_keygen_and_sign_shapes(dev, rng, ctx, sk, pk, priv, msg943,
                                  len943, sig943):
    """Keygen and the fused sign on partial warps and blocks (RAGGED), plain
    and blinded, rank-1; sign also on 64-byte messages and one key
    broadcast over 16 messages; the fused cap at 943/944 bytes, and 944-byte
    messages through the composed route, against the plain version."""
    zr = blinding.default_zr(device=dev)
    blind = dict(zr=ctx["zr"], bl=ctx["bl"], bp=ctx["bp"])
    for n in RAGGED:
        assert torch.equal(sign_kernel.keygen(sk[:n], zr=zr), pk[:n]), n
        assert torch.equal(sign_kernel.keygen(sk[:n], **blind), pk[:n]), n
    assert torch.equal(sign_kernel.keygen(sk[9], zr=zr), pk[9])

    ml64 = rng.integers(0, 65, len(sk)).astype(np.int32)
    ml64[:2] = 0, 64
    ml64 = on(dev, ml64)
    msg64 = msg943[:, :64]
    sig64 = sign_kernel.sign_fused(priv, msg64, ml64, zr=zr)
    assert torch.equal(sig64, sign_kernel.sign_plain(priv, msg64, ml64, zr=zr))
    assert torch.equal(sign_kernel.sign_fused(priv, msg64, ml64, **blind),
                       sig64)
    for m, ml, sig in ((msg64, ml64, sig64), (msg943, len943, sig943)):
        for n in RAGGED:
            assert torch.equal(sign_kernel.sign_fused(
                priv[:n], m[:n], ml[:n], zr=zr), sig[:n]), n
            assert torch.equal(sign_kernel.sign_fused(
                priv[:n], m[:n], ml[:n], **blind), sig[:n]), n
    assert torch.equal(sign_kernel.sign_fused(priv[3], msg943[3], len943[3],
                                              zr=zr), sig943[3])
    assert torch.equal(
        sign_kernel.sign_fused(priv[0], msg943[:16], len943[:16], zr=zr),
        sign_kernel.sign_plain(priv[0], msg943[:16], len943[:16], zr=zr))
    assert sign_kernel.max_fused_msg_len(943)
    assert not sign_kernel.max_fused_msg_len(944)
    m944 = rand_u8(dev, rng, 256, 944)
    n944 = torch.full((256,), 944, dtype=torch.int32, device=dev)
    assert torch.equal(
        sign_kernel.sign_composed(priv[:256], m944, n944, zr=zr),
        sign_kernel.sign_plain(priv[:256], m944, n944, zr=zr))


def _check_ed25519_known_answers(dev, rng):
    """RFC 8032 7.1 TEST 1-3 (pk and signature), and random seeds' keys and
    signatures of 64-byte and up to 3,000-byte messages against the
    Python-integer Ed25519."""
    pk, priv = ed25519.create_keypair(hex_rows(dev, [v[0] for v in ED_VECS]))
    assert [row(r).hex() for r in pk] == [v[1] for v in ED_VECS]
    msg = torch.zeros((3, 8), dtype=torch.uint8, device=dev)
    for i, v in enumerate(ED_VECS):
        b = bytes.fromhex(v[2])
        msg[i, :len(b)] = torch.tensor(list(b), dtype=torch.uint8)
    lengths = on(dev, np.array([len(v[2]) // 2 for v in ED_VECS], np.int32))
    sig = ed25519.sign(priv, msg, lengths)
    assert [row(r).hex() for r in sig] == [v[3] for v in ED_VECS]

    seeds = rng.integers(0, 256, (ORACLE_LANES, 32), dtype=np.uint8)
    pk, priv = ed25519.create_keypair(on(dev, seeds))
    for i in range(ORACLE_LANES):
        assert row(pk[i]) == curve.public_key(seeds[i].tobytes()), i
    for width in (64, 3000):
        m = rng.integers(0, 256, (ORACLE_LANES, width), dtype=np.uint8)
        n = rng.integers(0, width + 1, ORACLE_LANES).astype(np.int32)
        n[0] = width
        sig = ed25519.sign(priv, on(dev, m), on(dev, n))
        for i in range(ORACLE_LANES):
            assert row(sig[i]) == curve.sign(seeds[i].tobytes(),
                                             m[i, :n[i]].tobytes()), (width, i)


def test_verify_kernels_equal_plain(dev, rng):
    n = CHECK_LANES
    pk, _ = ed25519.create_keypair(rand_u8(dev, rng, n, 32))
    pk[n // 2:] = rand_u8(dev, rng, n - n // 2, 32)     # half off the curve
    pk[:len(EDGE_PK)] = le_rows(dev, EDGE_PK)
    s = rand_u8(dev, rng, n, 64)[:, 32:]                # S inside signature rows
    s[:len(EDGE_S)] = le_rows(dev, EDGE_S)
    md = rand_u8(dev, rng, n, 64)
    md[:2] = torch.tensor([[0] * 64, [255] * 64], dtype=torch.uint8)
    before = dict(verify_kernel.launches)
    u, v = verify_kernel.digits(md, s)
    assert torch.equal(u, fold.cut8_bytes(s))
    assert torch.equal(v, fold.cut4_limbs(sc.from_digest(md)))
    planes, ok = verify_kernel.verify_init(pk)
    assert same((planes, ok), verify_kernel.verify_init_plain(pk))
    assert n // 2 < int(ok.sum()) < n
    r = verify_kernel.poly_mult(u, v, planes)
    assert torch.equal(r, verify_kernel.poly_mult_plain(u, v, planes))
    shared = verify_kernel.poly_mult(u, v, planes[n - 1])
    assert torch.equal(shared, verify_kernel.poly_mult_plain(u, v,
                                                             planes[n - 1]))
    assert torch.equal(shared[n - 1], r[n - 1])
    r1, ok1 = verify_kernel.verify_oneshot(pk, u, v)
    torch.cuda.synchronize()
    assert torch.equal(r1, r) and torch.equal(ok1, ok)
    assert verify_kernel.launches == dict(before, **{
        k: before[k] + 1 for k in ("verify_init", "poly", "poly_shared",
                                   "oneshot", "digits")})
    assert same((r1, ok1), verify_kernel.verify_oneshot_plain(pk, u, v))
    _check_verify_kernel_shapes(pk, u, v, md, s, planes, ok, r)
    _check_digits_kernel(dev)
    _check_keyed_kernel(dev)


def _check_verify_kernel_shapes(pk, u, v, md, s, planes, ok, r):
    """The shared q_tables of lanes 0, 3, 9 (y = 0, y = p, a valid key);
    every verify kernel and the digits at the RAGGED sizes; rank-1 calls (a
    rank-1 q_table takes the shared kernel); one key, one s and one S over
    16 lanes."""
    vk = verify_kernel
    shared = {}
    for i in (0, 3, 9):
        shared[i] = vk.poly_mult(u, v, planes[i])
        assert torch.equal(shared[i], vk.poly_mult_plain(u, v, planes[i])), i
    for n in RAGGED:
        assert same(vk.digits(md[:n], s[:n]), (u[:n], v[:n])), n
        assert same(vk.verify_init(pk[:n]), (planes[:n], ok[:n])), n
        assert torch.equal(vk.poly_mult(u[:n], v[:n], planes[:n]), r[:n]), n
        assert torch.equal(vk.poly_mult(u[:n], v[:n], planes[9]),
                           shared[9][:n]), n
        assert same(vk.verify_oneshot(pk[:n], u[:n], v[:n]),
                    (r[:n], ok[:n])), n
    assert same(vk.verify_init(pk[5]), (planes[5], ok[5]))
    assert torch.equal(vk.poly_mult(u[5], v[5], planes[5]), r[5])
    assert same(vk.verify_oneshot(pk[5], u[5], v[5]), (r[5], ok[5]))
    r1, ok1 = vk.verify_oneshot(pk[9], u[:16], v[:16])
    r0, ok0 = vk.verify_oneshot_plain(pk[9], u[:16], v[:16])
    assert torch.equal(r1, r0) and torch.equal(ok1, ok0)
    assert torch.equal(vk.poly_mult(u[0], v[:16], planes[:16]),
                       vk.poly_mult_plain(u[0], v[:16], planes[:16]))
    assert same(vk.digits(md[:16], s[5]), (u[5].expand(16, 32), v[:16]))


def _check_digits_kernel(dev):
    """The digits kernel equals the plain calls it replaces
    (fold.cut8_bytes of S, fold.cut4_limbs(sc.from_digest(md))) at a packet
    batch (165,000) and a token batch (262,144), with S at l's edges and
    S + l lanes, S read in place from signature rows, broadcast from one
    row and read at an unaligned stride; verify and verify_check launch it
    once a call and record no span of the plain calls; verify_tablefree
    launches no hand-written kernel."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)

    def rand(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8)

    edges = EDGE_S
    for n in (165_000, 262_144):
        md, sig = rand(n, 64), rand(n, 64)
        md[:2] = torch.tensor([[0] * 64, [255] * 64], dtype=torch.uint8)
        s_plus_l = [int.from_bytes(bytes(r), "little") % ELL + ELL
                    for r in sig[len(edges):len(edges) + 64, 32:].tolist()]
        sig[:len(edges) + 64, 32:] = torch.tensor(
            [list(x.to_bytes(32, "little")) for x in edges + s_plus_l],
            dtype=torch.uint8)
        want_u = fold.cut8_bytes(sig[:, 32:])
        want_v = fold.cut4_limbs(sc.from_digest(md))
        before = verify_kernel.launches["digits"]
        u, v = verify_kernel.digits(md, sig[:, 32:])
        assert verify_kernel.launches["digits"] == before + 1
        assert torch.equal(u, want_u) and torch.equal(v, want_v), n
    one_u, one_v = verify_kernel.digits(md[:300], sig[9, 32:])
    assert torch.equal(one_u, want_u[9].expand(300, 32))
    assert torch.equal(one_v, want_v[:300])
    odd = rand(300, 97)                          # rows 97 bytes apart, at 1
    odd[:, 1:33] = sig[:300, 32:]
    odd[:, 33:] = md[:300]
    odd_u, odd_v = verify_kernel.digits(odd[:, 33:], odd[:, 1:33])
    assert torch.equal(odd_u, want_u[:300]) and torch.equal(odd_v,
                                                            want_v[:300])
    torch.cuda.synchronize()

    pk, priv = ed25519.create_keypair(rand(40, 32))
    msg = rand(40, 300)
    lengths = torch.randint(0, 301, (40,), generator=gen, device=dev,
                            dtype=torch.int32)
    sig = ed25519.sign(priv, msg, lengths)
    ctx, one = ed25519.verify_init(pk), ed25519.verify_init(pk[0])
    one_sig = ed25519.sign(priv[0], msg, lengths)
    plain = ("sc.from_digest", "fold.cut8_bytes", "fold.cut4_limbs")
    for fn, args in ((ed25519.verify, (sig, pk, msg, lengths)),
                     (ed25519.verify_check, (ctx, sig, msg, lengths)),
                     (ed25519.verify_check, (one, one_sig, msg, lengths))):
        before = verify_kernel.launches["digits"]
        profiling.start_spans()
        try:
            got = fn(*args)
        finally:
            records = profiling.stop_spans()
        assert bool(got.all())
        assert verify_kernel.launches["digits"] == before + 1
        names = {r[2] for r in records}
        assert "ed25519.digits" in names and not names & set(plain), names
    before = dict(verify_kernel.launches)
    assert bool(ed25519.verify_tablefree(sig, pk, msg, lengths).all())
    assert verify_kernel.launches == before


def _check_keyed_kernel(dev):
    """The lookup and keyed poly kernels at a vote batch: 165,000 lanes over
    a table of 1,500 keys (8 of them the edge keys, some that fail to
    decode), one lane in 512 and a run of 300 lanes signed by keys of their
    own, one lane a cached key with a byte changed past its prefix. The
    lookup finds each lane's row (the plain version's), orders the misses
    first and counts them; hit lanes equal poly_kernel on the planes
    materialized per lane and carry their key's flag, miss lanes equal the
    one-shot kernel. Then every lane a miss at more lanes than the
    scratch's wave (its threads take the misses in turns), the RAGGED sizes
    and one lane, the launch counts and the tally of cached_lanes; and
    verify_cached equal to verify on signed lanes, strict and not, with
    CUDA's sync debug mode set to raise on any wait for the device, for
    lanes on the card and for page-locked lanes in host memory (copied in
    in two parts); host lanes at 0, 1 and 3 lanes and unbatched."""
    vk = verify_kernel
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)

    def rand(*shape, high=256, dtype=torch.uint8):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=dtype)

    n, k = 165_000, 1_500
    keys, _ = ed25519.create_keypair(rand(k, 32))
    keys[:len(EDGE_PK)] = le_rows(dev, EDGE_PK)
    keys[len(EDGE_PK):len(EDGE_PK) + 40] = rand(40, 32)   # most off the curve
    planes, key_ok = vk.verify_init(keys)
    assert 0 < int(key_ok.sum()) < k
    want_key = rand(n, high=k, dtype=torch.int32)
    want_key[::512] = -1
    want_key[1000:1300] = -1
    miss = want_key < 0
    pk = keys[want_key.clamp(min=0)]
    pk[miss] = rand(int(miss.sum()), 32)
    pk[miss.nonzero()[::2, 0]] = ed25519.create_keypair(
        rand(-(-int(miss.sum()) // 2), 32))[0]
    pk[2048, 20] ^= 1                   # a cached key's prefix, another key
    want_key[2048], miss[2048] = -1, True
    index = (keys, vk.key_index(keys))
    u = fold.cut8_bytes(rand(n, 32))
    v = fold.cut4_limbs(sc.from_digest(rand(n, 64)))
    u[:2], v[:2] = 255, 15
    before, tally = dict(vk.launches), {
        name: int(c) for name, c in vk.cached_lanes.items()}
    lookup = vk.key_lookup(pk, *index)
    key, order, counts = lookup
    misses = int(miss.sum())
    assert torch.equal(key, want_key) and counts.tolist() == [misses,
                                                              n - misses]
    assert torch.equal(key, vk.key_lookup_plain(pk, *index)[0])
    assert torch.equal(order.sort().values, torch.arange(n, device=dev))
    assert bool(miss[order[:misses]].all())
    r, ok = vk.poly_keyed(u, v, lookup, planes, key_ok, pk)
    torch.cuda.synchronize()
    assert vk.launches == dict(before, key_lookup=before["key_lookup"] + 1,
                               poly_keyed=before["poly_keyed"] + 1)
    assert {name: int(c) - tally[name] for name, c in vk.cached_lanes.items()
            } == {"hit": n - misses, "miss": misses}
    hit = ~miss
    at = key.clamp(min=0)
    want = vk.poly_mult(u[hit], v[hit], planes[at[hit]])
    assert torch.equal(r[hit], want) and torch.equal(ok[hit],
                                                     key_ok[at[hit]])
    want = vk.verify_oneshot(pk[miss], u[miss], v[miss])
    assert same((r[miss], ok[miss]), want) and 0 < int(want[1].sum())
    m = vk.keyed_scratch_rows(1 << 30, dev) + 999
    strangers = ed25519.create_keypair(rand(m, 32))[0]
    every = vk.key_lookup(strangers, *index)
    assert every[2].tolist() == [m, 0]
    assert same(vk.poly_keyed(u[:m], v[:m], every, planes, key_ok, strangers),
                vk.verify_oneshot(strangers, u[:m], v[:m]))
    for m in RAGGED + (1300,):
        assert same(vk.poly_keyed(u[:m], v[:m], vk.key_lookup(pk[:m], *index),
                                  planes, key_ok, pk[:m]), (r[:m], ok[:m])), m
    assert same(vk.poly_keyed(u[5], v[5], vk.key_lookup(pk[5], *index),
                              planes, key_ok, pk[5]), (r[5], ok[5]))
    assert same(vk.poly_keyed_plain(u[990:1010], v[990:1010],
                                    key[990:1010], planes, key_ok,
                                    pk[990:1010]), (r[990:1010],
                                                    ok[990:1010]))

    signers, priv = ed25519.create_keypair(rand(64, 32))
    ctx = ed25519.verify_init(signers[:48])
    lanes = rand(4096, high=64, dtype=torch.int64)
    msg, lengths = rand(4096, 330), rand(4096, high=331, dtype=torch.int32)
    sig = ed25519.sign(priv[lanes], msg, lengths)
    sig[::16, 7] ^= 1
    sig[3::16, 40] ^= 1
    msg[5::16, 0] ^= 1
    sig[9::16, 32:] = le_rows(dev, [int.from_bytes(row(b), "little") + ELL
                                    for b in sig[9::16, 32:]])  # S + l
    for strict in (False, True):
        want = ed25519.verify(sig, signers[lanes], msg, lengths,
                              strict=strict)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = ed25519.verify_cached(ctx, sig, signers[lanes], msg,
                                        lengths, strict=strict)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(got, want), strict
        assert 0 < int(got.sum()) < 4096
        host = [t.cpu().pin_memory() for t in (sig, signers[lanes], msg,
                                               lengths)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = ed25519.verify_cached(ctx, *host, strict=strict)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert got.is_cuda and torch.equal(got, want), strict
    for m in (0, 1, 3):
        assert torch.equal(ed25519.verify_cached(
            ctx, sig[:m].cpu(), signers[lanes][:m].cpu(), msg[:m].cpu(),
            lengths[:m].cpu(), strict=True), want[:m]), m
    assert torch.equal(ed25519.verify_cached(ctx, sig[7].cpu(),
                                             signers[lanes[7]].cpu(),
                                             msg[7].cpu(), 330),
                       ed25519.verify(sig[7], signers[lanes[7]], msg[7]))


def test_partial_warps_and_tiles(dev, rng):
    """The persistent one-shot kernel with fewer lanes than one block, than
    its grid, and more than its grid holds at once (its blocks run several
    rounds: a packet batch of 165,000 lanes, and 2.5 waves and 17 lanes),
    against the two phases, and its counter of the busiest block's warps;
    the SHA-512 kernel's warp staging on partial warps and blocks (n = 1,
    31, 33, 127, 129) with block counts (1-5) that differ inside each warp.
    (The gathers of keygen, sign and the fold-8 base multiply on partial
    warps are held at the RAGGED sizes by the tests of those kernels.)"""
    wave = verify_kernel.oneshot_scratch_rows(1 << 30, dev)
    sizes = (1, 31, 33, 300, wave + 33, 165_000, 5 * wave // 2 + 17)
    lanes = max(sizes)
    pk, _ = ed25519.create_keypair(on(dev, rng.integers(0, 256, (lanes, 32),
                                                         dtype=np.uint8)))
    u = fold.cut8_bytes(on(dev, rng.integers(0, 256, (lanes, 32),
                                             dtype=np.uint8)))
    v = fold.cut4_limbs(sc.from_digest(on(dev, rng.integers(
        0, 256, (lanes, 64), dtype=np.uint8))))
    planes, ok = verify_kernel.verify_init(pk)
    r = verify_kernel.poly_mult(u, v, planes)
    for n in sizes:
        before = dict(verify_kernel.oneshot_warps)
        r1, ok1 = verify_kernel.verify_oneshot(pk[:n], u[:n], v[:n])
        assert torch.equal(r1, r[:n]) and torch.equal(ok1, ok[:n]), n
        if n == 165_000:            # busiest 40, mean 39.07 on 132 SMs
            grid = min(-(-n // 512), wave // 512)
            warps = -(-n // 32)
            got = {k: verify_kernel.oneshot_warps[k] - before[k]
                   for k in before}
            assert got["busiest"] == -(-warps // grid), got
            assert got["mean"] == pytest.approx(warps / grid), got
    plain = verify_kernel.verify_oneshot_plain(pk[:33], u[:33], v[:33])
    assert torch.equal(plain[0], r[:33]) and torch.equal(plain[1], ok[:33])
    msg = on(dev, rng.integers(0, 256, (129, 600), dtype=np.uint8))
    lengths = on(dev, rng.integers(0, 601, 129).astype(np.int32))
    digest = sha512.sha512_plain(msg, lengths)
    for n in (1, 31, 33, 127, 129):
        assert torch.equal(sha512.sha512(msg[:n], lengths[:n]), digest[:n]), n


def test_verify_paths_on_the_card(dev, rng):
    """verify, verify_check (a context per key and one shared key's) and
    verify_tablefree on signatures of messages of 0-1,200 bytes (up to 10
    SHA-512 blocks behind R || A): valid lanes, a bit of R, of S, of the
    message, and a shorter message; then the known answers and the ragged
    batches."""
    n = 512
    pk, priv = ed25519.create_keypair(rand_u8(dev, rng, n, 32))
    msg = rand_u8(dev, rng, n, 1200)
    lengths = rng.integers(0, 1201, n).astype(np.int32)
    lengths[:4] = 0, 1200, 600, 700
    lengths = on(dev, lengths)
    sig = ed25519.sign(priv, msg, lengths)
    one = ed25519.sign(priv[0], msg, lengths)          # one key, n messages
    sig[4, 0] ^= 1                                     # R
    sig[5, 40] ^= 1                                    # S
    one[6, 33] ^= 1
    msg[2, 10] ^= 1                                    # the message
    lengths[3] -= 1                                    # a shorter message
    want = torch.ones(n, dtype=torch.bool, device=dev)
    want[2:6] = False
    want_one = torch.ones(n, dtype=torch.bool, device=dev)
    want_one[[2, 3, 6]] = False
    ctx, ctx_one = ed25519.verify_init(pk), ed25519.verify_init(pk[0])
    assert torch.equal(ed25519.verify(sig, pk, msg, lengths), want)
    assert torch.equal(ed25519.verify_check(ctx, sig, msg, lengths), want)
    assert torch.equal(ed25519.verify_tablefree(sig, pk, msg, lengths), want)
    assert torch.equal(ed25519.verify_tablefree(one, pk[0], msg, lengths),
                       want_one)
    assert torch.equal(ed25519.verify_check(ctx_one, one, msg, lengths),
                       want_one)
    host = [refmodel.ed_verify(row(s), row(p), row(m[:k]))
            for s, p, m, k in zip(sig[:6], pk[:6], msg[:6],
                                  lengths[:6].tolist())]
    assert host == want[:6].tolist()
    numpy_in = ed25519.verify(*(t.cpu().numpy() for t in (sig, pk, msg,
                                                           lengths)))
    assert numpy_in.is_cuda and torch.equal(numpy_in, want)
    _check_verify_known_answers(dev, rng)
    _check_ragged_sign_and_verify_on_the_card(dev, rng)


def _edge_vectors():
    """The 16 vectors of tests/test_edge_encodings.py (name, pk, sig, msg,
    verdict, strict verdict), rebuilt on the Python-integer reference."""
    def le(v):
        return v.to_bytes(32, "little")

    def base_enc(k):
        return curve.encode(curve.base_mult(k))

    seed = b"\x01" * 32
    pk = curve.public_key(seed)
    sig = curve.sign(seed, EDGE_MSG)
    s_int = int.from_bytes(sig[32:], "little")
    a, _ = curve.secret_scalar(seed)

    def forge_for(pk_bytes, order):
        for s_try in range(1, 400):
            r = base_enc(s_try)
            if curve.challenge(r, pk_bytes, EDGE_MSG) % order == 0:
                return r + le(s_try)
        raise AssertionError("no forgery scalar found")

    forge_id = base_enc(12345) + le(12345)
    r_id, r_nc = le(1), le(P + 1)        # enc(identity), and non-canonical
    sig_r0 = r_id + le(curve.challenge(r_id, pk, EDGE_MSG) * a % ELL)
    sig_rnc = r_nc + le(curve.challenge(r_nc, pk, EDGE_MSG) * a % ELL)
    return [
        ("valid", pk, sig, EDGE_MSG, True, True),
        ("tampered-msg", pk, sig, b"edge vector msg?", False, False),
        ("tampered-sig", pk, bytes([sig[0] ^ 1]) + sig[1:], EDGE_MSG, False,
         False),
        ("pk-not-on-curve", le(2), sig, EDGE_MSG, False, False),
        ("pk-max-y", le(2**255 - 1), sig, EDGE_MSG, False, False),
        ("identity-pk-forge", le(1), forge_id, EDGE_MSG, True, True),
        ("identity-pk-noncanonical", le(P + 1), forge_id, EDGE_MSG, True,
         True),
        ("identity-pk-signbit", le(1 | 1 << 255), forge_id, EDGE_MSG, True,
         True),
        ("zero-pk-forge", le(0), forge_for(le(0), 8), EDGE_MSG, True, True),
        ("zero-pk-noncanonical", le(P), forge_for(le(P), 8), EDGE_MSG, True,
         True),
        ("malleable-s-plus-l", pk, sig[:32] + le(s_int + ELL), EDGE_MSG, True,
         False),
        ("malleable-s-plus-2l", pk, sig[:32] + le(s_int + 2 * ELL), EDGE_MSG,
         True, False),
        ("s-all-ff", pk, sig[:32] + b"\xff" * 32, EDGE_MSG, False, False),
        ("s-zero", pk, sig[:32] + bytes(32), EDGE_MSG, False, False),
        ("r-zero-sig", pk, sig_r0, EDGE_MSG, True, True),
        ("noncanonical-R-bytes", pk, sig_rnc, EDGE_MSG, False, False),
    ]


def _check_verify_known_answers(dev, rng):
    """RFC 8032 TEST 1-3 verify and their tampered R, S and messages do not
    (verify, verify_check, a shared key's verify_check); the 16 edge
    vectors (strict and not) through verify, verify_check of Verify_Init's
    contexts and verify_tablefree, their Verify_Init byte-equal to plain;
    random lanes through verify and verify_check against the Python-integer
    verify."""
    pk = hex_rows(dev, [v[1] for v in ED_VECS])
    sig = hex_rows(dev, [v[3] for v in ED_VECS])
    msg = torch.zeros((3, 8), dtype=torch.uint8, device=dev)
    for i, v in enumerate(ED_VECS):
        b = bytes.fromhex(v[2])
        msg[i, :len(b)] = torch.tensor(list(b), dtype=torch.uint8)
    ml = on(dev, np.array([len(v[2]) // 2 for v in ED_VECS], np.int32))
    ctx = ed25519.verify_init(pk)
    for tamper in (None, "R", "S", "msg"):
        s, n = sig.clone(), ml + (tamper == "msg")
        if tamper in ("R", "S"):
            s[:, 1 if tamper == "R" else 40] ^= 1
        want = [tamper is None] * 3
        got = [ed25519.verify(s, pk, msg, n).tolist(),
               ed25519.verify_check(ctx, s, msg, n).tolist(),
               [bool(ed25519.verify_check(ed25519.verify_init(pk[i]), s[i],
                                          msg[i], n[i])) for i in range(3)]]
        assert got == [want] * 3, tamper

    vecs = _edge_vectors()
    pks, sigs, msgs = (on(dev, np.stack([np.frombuffer(v[k], np.uint8)
                                         for v in vecs])) for k in (1, 2, 3))
    ctx = ed25519.verify_init(pks)
    assert same((ctx["planes"], ctx["ok"]), verify_kernel.verify_init_plain(pks))
    half = ed25519.verify_init(pks[::2])          # the other half not cached
    for strict in (False, True):
        want = [v[5 if strict else 4] for v in vecs]
        assert [curve.verify(v[2], v[1], v[3], strict) for v in vecs] == want
        for label, got in (
                ("verify", ed25519.verify(sigs, pks, msgs, strict=strict)),
                ("verify_check", ed25519.verify_check(ctx, sigs, msgs,
                                                      strict=strict)),
                ("verify_tablefree", ed25519.verify_tablefree(
                    sigs, pks, msgs, strict=strict)),
                ("verify_cached", ed25519.verify_cached(
                    half, sigs, pks, msgs, strict=strict))):
            bad = [v[0] for v, g, w in zip(vecs, got.tolist(), want) if g != w]
            assert not bad, (label, strict, bad)

    pk, priv = ed25519.create_keypair(rand_u8(dev, rng, ORACLE_LANES, 32))
    msg = rand_u8(dev, rng, ORACLE_LANES, 64)
    sig = ed25519.sign(priv, msg)
    sig[1, 2] ^= 1
    sig[2, 50] ^= 1
    got = ed25519.verify(sig, pk, msg).tolist()
    got_ctx = ed25519.verify_check(ed25519.verify_init(pk), sig, msg).tolist()
    want = [curve.verify(row(sig[i]), row(pk[i]), row(msg[i]))
            for i in range(ORACLE_LANES)]
    assert want == [True, False, False, True]
    assert got == want and got_ctx == want


def _ragged_launches(lengths, route):
    """The kernel launches of one ragged call over messages of `lengths`:
    per SHA-512 block bucket, the fused sign (one launch after two
    packings) or the composed one (3 SHA-512, each after its packing, and 1
    base multiply); a verify check is one packing, one SHA-512, one digits
    kernel and one double-scalar multiply (`route`)."""
    want = Counter()
    for nb in bucketing.bucket_indices(lengths):
        if route == "sign" and sign_kernel.max_fused_msg_len(
                bucketing.bucket_length(nb)):
            want.update(sign=1, pack_words=2)
        elif route == "sign":
            want.update(sha512=3, pack_words=3, basemult=1)
        else:
            want.update({"sha512": 1, "pack_words": 1, "digits": 1, route: 1})
    return dict(want)


def _check_ragged_sign_and_verify_on_the_card(dev, rng, n=RAGGED_MSGS):
    """sign_ragged of n messages of 0-1,200 bytes (10 SHA-512 block
    buckets, both sign routes) equals the padded-batch sign and the
    Python-integer oracle, unchanged by blinding; verify_ragged is true on
    every valid lane and false on the tampered ones, with Verify_Init once
    per batch, none given a context, and a rank-1 key taking the shared
    q_table. Every call launches exactly its buckets' kernels."""
    lengths = rng.integers(0, RAGGED_MAX + 1, n)
    # the last fused bucket (7 blocks, 879 bytes) and the first composed one
    lengths[:3] = 0, 879, 880
    flat = rng.bytes(int(lengths.sum()))
    ofs = np.concatenate([[0], np.cumsum(lengths)])
    msgs = [flat[ofs[i]:ofs[i + 1]] for i in range(n)]
    assert len(bucketing.bucket_indices(lengths)) == 10
    seeds = rand_u8(dev, rng, n, 32)
    pk, priv = ed25519.create_keypair(seeds)
    want_sign = _ragged_launches(lengths, "sign")
    sig, got = _launched(ed25519.sign_ragged, priv, msgs)
    assert sig.is_cuda and got == want_sign, got
    padded = np.zeros((n, RAGGED_MAX), np.uint8)
    for i, m in enumerate(msgs):
        padded[i, :len(m)] = np.frombuffer(m, np.uint8)
    assert torch.equal(sig, ed25519.sign(priv, on(dev, padded),
                                         on(dev, lengths.astype(np.int32))))
    for i in (0, 1, 2, int(np.argmax(lengths)), n // 2, n - 1):
        assert row(sig[i]) == curve.sign(row(seeds[i]), msgs[i]), i
    ctx_bl = blinding.blinding_init(b"ragged", device=dev)
    sig_bl, got = _launched(ed25519.sign_ragged, priv, msgs, blinding=ctx_bl)
    assert got == want_sign and torch.equal(sig_bl, sig)

    bad = [3, n // 3, n - 2]
    sig[bad[0], 0] ^= 1                           # R
    sig[bad[1], 40] ^= 1                          # S
    sig[bad[2]] = sig[bad[2] - 1]                 # another message's
    want = torch.ones(n, dtype=torch.bool, device=dev)
    want[bad] = False
    checks = _ragged_launches(lengths, "poly")
    got, launched = _launched(ed25519.verify_ragged, sig, pk, msgs)
    assert launched == dict(checks, verify_init=1), launched
    assert torch.equal(got, want)
    ctx = ed25519.verify_init(pk)
    got, launched = _launched(ed25519.verify_ragged, sig, None, msgs, ctx=ctx)
    assert launched == checks and torch.equal(got, want), launched

    one = ed25519.sign_ragged(priv[0], msgs)
    one[bad[0], 63] ^= 1
    want_one = torch.ones(n, dtype=torch.bool, device=dev)
    want_one[bad[0]] = False
    got, launched = _launched(ed25519.verify_ragged, one, pk[0], msgs)
    assert launched == dict(_ragged_launches(lengths, "poly_shared"),
                            verify_init=1), launched
    assert torch.equal(got, want_one)


def _check_oo_card_route_equals_host_core(rng):
    """The OO classes with no device (the card) give the host core's bytes
    and verdicts."""
    from curve25519_tpu_torch import oo
    a_sk, b_sk, seed = rng.bytes(32), rng.bytes(32), rng.bytes(32)
    b_pk = oo.X25519Private(b_sk, native=True).get_public_key()
    card, host = oo.X25519Private(a_sk), oo.X25519Private(a_sk, native=True)
    assert card.get_public_key() == host.get_public_key()
    for kdf in (False, True):
        assert card.create_shared_key(b_pk, kdf) == host.create_shared_key(
            b_pk, kdf)
    card, host = oo.ED25519Private(seed), oo.ED25519Private(seed,
                                                             native=True)
    assert card.get_public_key() == host.get_public_key()
    pub = oo.ED25519Public(card.get_public_key())
    for msg in (b"", rng.bytes(1000)):
        sig = card.sign(msg)
        assert sig == host.sign(msg)
        assert pub.verify(sig, msg)
        assert not pub.verify(sig[:-1] + bytes([sig[-1] ^ 1]), msg)
