"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card and nvcc, is marked `cuda`, and skips
where torch.cuda.is_available() is false. The file imports no jax, so it also
runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: exact bytes.
"""

import hashlib

import numpy as np
import pytest
import torch

from curve25519_tpu import refmodel
from curve25519_tpu.config import P

from curve25519_tpu_torch.config import ELL, int_to_limbs
from curve25519_tpu_torch.models import blinding, ed25519, montgomery, x25519
from curve25519_tpu_torch.ops import fold, sc, sha512
from curve25519_tpu_torch.ops.cuda import (
    edwards_kernel, ladder_kernel, sha512_kernel, sign_kernel, verify_kernel,
)
from curve25519_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

# RFC 7748 5.2 vector 1 and the x25519_edge_u values of
# benchmarks/tpu_vectors.py
V1_K = "a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4"
V1_U = "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c"
V1_OUT = "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"
EDGE_U = [0, 1, P, P + 1, 2**255 - 1, 1 | 1 << 255]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def rng():
    return np.random.default_rng(90)


def on(dev, arr):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def test_kernel_equals_plain(dev, rng):
    n = 1024 + 37                                  # not a multiple of a block
    sk = on(dev, rng.integers(0, 256, (n, 32), dtype=np.uint8))
    peer = on(dev, rng.integers(0, 256, (n, 32), dtype=np.uint8))
    zr = on(dev, np.stack([int_to_limbs(int.from_bytes(rng.bytes(32), "little")
                                        % P or 1) for _ in range(n)]))
    before = ladder_kernel.launches
    got = x25519.create_shared_key(peer, sk)
    torch.cuda.synchronize()
    assert ladder_kernel.launches == before + 1
    assert torch.equal(got, montgomery.point_multiply(peer, sk))
    assert torch.equal(x25519.create_shared_key(peer, sk, zr=zr), got)
    assert torch.equal(x25519.create_shared_key(peer[7], sk[7]), got[7])
    assert torch.equal(x25519.create_shared_key(peer[0], sk[:9]),
                       montgomery.point_multiply(peer[0], sk[:9]))


def test_kernel_known_answers(dev):
    k = on(dev, np.frombuffer(bytes.fromhex(V1_K), np.uint8))
    u = on(dev, np.frombuffer(bytes.fromhex(V1_U), np.uint8))
    assert bytes(x25519.create_shared_key(u, k).cpu().tolist()).hex() == V1_OUT
    peers = on(dev, np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8)
                              for v in EDGE_U]))
    sk7 = torch.full((len(EDGE_U), 32), 7, dtype=torch.uint8, device=dev)
    got = x25519.create_shared_key(peers, sk7).cpu().numpy()
    for row, v in zip(got, EDGE_U):
        assert row.tobytes() == refmodel.x25519(b"\x07" * 32,
                                                v.to_bytes(32, "little"))


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
    sk = on(dev, rng.integers(0, 256, (300, 32), dtype=np.uint8))
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
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), mode
    assert torch.equal(x25519.calculate_public_key_fast(sk, nfolds=nfolds),
                       x25519.calculate_public_key(sk))


def test_sha512_kernel_equals_plain_and_hashlib(dev, rng):
    msg = rng.integers(0, 256, (9, 240), dtype=np.uint8)
    lengths = np.array([0, 1, 111, 112, 127, 128, 129, 239, 240], np.int32)
    before = sha512_kernel.launches
    got = sha512.sha512(on(dev, msg), on(dev, lengths))
    assert sha512_kernel.launches == before + 1
    counts = sha512_kernel.launches, sha512_kernel.pack_launches
    assert torch.equal(got, sha512.sha512_plain(on(dev, msg), on(dev, lengths)))
    # the reference launches neither hand-written kernel
    assert (sha512_kernel.launches, sha512_kernel.pack_launches) == counts
    assert [bytes(r) for r in got.cpu().numpy()] == [
        hashlib.sha512(m[:n].tobytes()).digest() for m, n in zip(msg, lengths)]
    _check_pack_kernel(dev, rng)


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
    sk = on(dev, rng.integers(0, 256, (130, 32), dtype=np.uint8))
    ctx = blinding.blinding_init(b"cuda", device=dev)
    zr = blinding.default_zr(device=dev)
    before = dict(sign_kernel.launches)
    pk, priv = ed25519.create_keypair(sk)
    assert torch.equal(pk, sign_kernel.keygen_plain(sk, zr=zr))
    assert torch.equal(ed25519.create_keypair(sk, blinding=ctx)[0], pk)
    msg = on(dev, rng.integers(0, 256, (130, 943), dtype=np.uint8))
    lengths = on(dev, rng.integers(0, 944, 130).astype(np.int32))
    sig = ed25519.sign(priv, msg, lengths)
    assert torch.equal(sig, sign_kernel.sign_plain(priv, msg, lengths, zr=zr))
    assert torch.equal(ed25519.sign(priv, msg, lengths, blinding=ctx), sig)
    assert sign_kernel.launches == {"keygen": before["keygen"] + 2,
                                    "sign": before["sign"] + 2}
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


def test_verify_kernels_equal_plain(dev, rng):
    n = 300
    pk, _ = ed25519.create_keypair(on(dev, rng.integers(0, 256, (n, 32),
                                                         dtype=np.uint8)))
    pk[n // 2:] = on(dev, rng.integers(0, 256, (n - n // 2, 32),
                                       dtype=np.uint8))   # half off the curve
    s = on(dev, rng.integers(0, 256, (n, 32), dtype=np.uint8))
    md = on(dev, rng.integers(0, 256, (n, 64), dtype=np.uint8))
    before = dict(verify_kernel.launches)
    u, v = verify_kernel.digits(md, s)
    assert torch.equal(u, fold.cut8_bytes(s))
    assert torch.equal(v, fold.cut4_limbs(sc.from_digest(md)))
    planes, ok = verify_kernel.verify_init(pk)
    want_planes, want_ok = verify_kernel.verify_init_plain(pk)
    assert torch.equal(planes, want_planes) and torch.equal(ok, want_ok)
    assert 0 < int(ok.sum()) < n
    r = verify_kernel.poly_mult(u, v, planes)
    assert torch.equal(r, verify_kernel.poly_mult_plain(u, v, planes))
    shared = verify_kernel.poly_mult(u, v, planes[n - 1])
    assert torch.equal(shared, verify_kernel.poly_mult_plain(u, v,
                                                             planes[n - 1]))
    assert torch.equal(shared[n - 1], r[n - 1])
    r1, ok1 = verify_kernel.verify_oneshot(pk, u, v)
    torch.cuda.synchronize()
    assert torch.equal(r1, r) and torch.equal(ok1, ok)
    assert verify_kernel.launches == {k: before[k] + 1 for k in before}
    _check_digits_kernel(dev)


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

    edges = [0, ELL - 1, ELL, ELL + 1, ELL + 2**200, 2**256 - 1, 2**255]
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


def test_partial_warps_and_tiles(dev, rng):
    """The warp-wide tensor-core gather of the keygen, sign and fold-8
    base-multiply kernels on partial warps and blocks (n = 1, 31, 33, 127,
    129), plain and blinded, every base-multiply mode; the SHA-512 kernel's
    warp staging at those n with block counts (1-5) that differ inside each
    warp; the persistent one-shot kernel with fewer lanes than one tile,
    than its grid, and more than its grid holds at once (its blocks loop
    over tiles), against the two phases."""
    sk = on(dev, rng.integers(0, 256, (129, 32), dtype=np.uint8))
    ctx = blinding.blinding_init(b"warps", device=dev)
    zr = blinding.default_zr(device=dev)
    cut = fold.cut8_bytes(sk)
    for mode in edwards_kernel.MODES:
        for bp in (None, ctx["bp"]):
            want = edwards_kernel.base_mult_plain(cut, zr=ctx["zr"], bp=bp,
                                                  mode=mode)
            want = want if isinstance(want, tuple) else (want,)
            for n in (1, 31, 33, 127, 129):
                got = edwards_kernel.base_mult(cut[:n], zr=ctx["zr"], bp=bp,
                                               mode=mode)
                got = got if isinstance(got, tuple) else (got,)
                assert all(torch.equal(g, w[:n]) for g, w in zip(got, want)), (
                    mode, bp is not None, n)
    pk = sign_kernel.keygen_plain(sk, zr=zr)
    for n in (1, 31, 33, 127, 129):
        assert torch.equal(sign_kernel.keygen(sk[:n], zr=zr), pk[:n]), n
        assert torch.equal(sign_kernel.keygen(
            sk[:n], zr=ctx["zr"], bl=ctx["bl"], bp=ctx["bp"]), pk[:n]), n
    sk = sk[:33]
    _, priv = ed25519.create_keypair(sk)
    msg = on(dev, rng.integers(0, 256, (33, 200), dtype=np.uint8))
    lengths = on(dev, rng.integers(0, 201, 33).astype(np.int32))
    want = sign_kernel.sign_plain(priv, msg, lengths, zr=zr)
    for n in (1, 31, 33):
        assert torch.equal(sign_kernel.sign_fused(priv[:n], msg[:n],
                                                  lengths[:n], zr=zr), want[:n])
        assert torch.equal(sign_kernel.sign_fused(
            priv[:n], msg[:n], lengths[:n], zr=ctx["zr"], bl=ctx["bl"],
            bp=ctx["bp"]), want[:n])
    lanes = verify_kernel.oneshot_scratch_rows(1 << 30, dev) + 33
    pk, _ = ed25519.create_keypair(on(dev, rng.integers(0, 256, (lanes, 32),
                                                         dtype=np.uint8)))
    u = fold.cut8_bytes(on(dev, rng.integers(0, 256, (lanes, 32),
                                             dtype=np.uint8)))
    v = fold.cut4_limbs(sc.from_digest(on(dev, rng.integers(
        0, 256, (lanes, 64), dtype=np.uint8))))
    planes, ok = verify_kernel.verify_init(pk)
    r = verify_kernel.poly_mult(u, v, planes)
    for n in (1, 31, 33, 300, lanes):
        r1, ok1 = verify_kernel.verify_oneshot(pk[:n], u[:n], v[:n])
        assert torch.equal(r1, r[:n]) and torch.equal(ok1, ok[:n]), n
    plain = verify_kernel.verify_oneshot_plain(pk[:33], u[:33], v[:33])
    assert torch.equal(plain[0], r[:33]) and torch.equal(plain[1], ok[:33])
    msg = on(dev, rng.integers(0, 256, (129, 600), dtype=np.uint8))
    lengths = on(dev, rng.integers(0, 601, 129).astype(np.int32))
    digest = sha512.sha512_plain(msg, lengths)
    for n in (1, 31, 33, 127, 129):
        assert torch.equal(sha512.sha512(msg[:n], lengths[:n]), digest[:n]), n


def test_verify_paths_on_the_card(dev, rng):
    n = 130
    pk, priv = ed25519.create_keypair(on(dev, rng.integers(0, 256, (n, 32),
                                                            dtype=np.uint8)))
    msg = on(dev, rng.integers(0, 256, (n, 1100), dtype=np.uint8))
    lengths = on(dev, rng.integers(0, 1101, n).astype(np.int32))
    sig = ed25519.sign(priv, msg, lengths)
    sig[3, 0] ^= 1
    sig[4, 40] ^= 1
    want = torch.ones(n, dtype=torch.bool, device=dev)
    want[3:5] = False
    ctx = ed25519.verify_init(pk)
    assert torch.equal(ed25519.verify(sig, pk, msg, lengths), want)
    assert torch.equal(ed25519.verify_check(ctx, sig, msg, lengths), want)
    assert torch.equal(ed25519.verify_tablefree(sig, pk, msg, lengths), want)
    one = ed25519.sign(priv[0], msg, lengths)
    got = ed25519.verify_check(ed25519.verify_init(pk[0]), one, msg, lengths)
    assert bool(got.all())
    host = [refmodel.ed_verify(bytes(s.cpu().tolist()), bytes(p.cpu().tolist()),
                               bytes(m[:k].cpu().tolist()))
            for s, p, m, k in zip(sig[:6], pk[:6], msg[:6], lengths[:6].tolist())]
    assert host == want[:6].tolist()
    numpy_in = ed25519.verify(*(t.cpu().numpy() for t in (sig, pk, msg,
                                                           lengths)))
    assert numpy_in.is_cuda and torch.equal(numpy_in, want)
    _check_ragged_sign_and_verify_on_the_card(dev, rng)


def _check_ragged_sign_and_verify_on_the_card(dev, rng):
    """sign_ragged across the fused and composed buckets against the oracle,
    unchanged by blinding; verify_ragged launches Verify_Init once per
    batch, and a rank-1 key takes the shared q_table."""
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 1201, 40)]
    # the last fused bucket (7 blocks, 879 bytes) and the first composed one
    msgs[:3] = [b"", bytes(879), bytes(880)]
    pk, priv = ed25519.create_keypair(on(dev, rng.integers(0, 256, (40, 32),
                                                            dtype=np.uint8)))
    sig = ed25519.sign_ragged(priv, msgs)
    assert sig.is_cuda
    for i in (0, 1, 2, 17):
        assert bytes(sig[i].cpu().tolist()) == refmodel.ed_sign(
            bytes(priv[i].cpu().tolist()), msgs[i]), i
    ctx = blinding.blinding_init(b"ragged", device=dev)
    assert torch.equal(ed25519.sign_ragged(priv, msgs, blinding=ctx), sig)
    sig[5, 2] ^= 1
    want = torch.ones(40, dtype=torch.bool, device=dev)
    want[5] = False
    before = dict(verify_kernel.launches)
    assert torch.equal(ed25519.verify_ragged(sig, pk, msgs), want)
    assert verify_kernel.launches["verify_init"] == before["verify_init"] + 1
    assert torch.equal(ed25519.verify_ragged(
        sig, None, msgs, ctx=ed25519.verify_init(pk)), want)
    one = ed25519.sign_ragged(priv[0], msgs)
    shared = verify_kernel.launches["poly_shared"]
    assert bool(ed25519.verify_ragged(one, pk[0], msgs).all())
    assert verify_kernel.launches["poly_shared"] > shared


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
