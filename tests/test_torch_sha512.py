"""The port's batched SHA-512 against hashlib and the JAX package's.

curve25519_tpu_torch.ops.sha512 on CPU tensors runs the plain compression
of ops/cuda/sha512_kernel.py; the g++ build of the kernel's lane code
(csrc/sha512.cu) runs on the same padded words. The streaming Sha512 runs
on both of its routes (the port's host core, and the plain compression with
device="cpu") against hashlib and the JAX package's Sha512 on its own host
core; the RNG built on it, the length buckets of utils/bucketing and their
scatter are held against the JAX package's. Inputs come from a seeded numpy
generator. Tolerance: exact bytes (and exact words for the padding).
"""

import functools
import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curve25519_tpu.ops import sha512 as jsha
from curve25519_tpu.ops.pallas import sha512_kernel as jshk
from curve25519_tpu.utils import bucketing as jbucketing
from curve25519_tpu.utils import rng as jrng

from curve25519_tpu_torch.native import bindings
from curve25519_tpu_torch.ops import sha512
from curve25519_tpu_torch.ops.cuda import build, sha512_kernel
from curve25519_tpu_torch.utils import bucketing, interop
from curve25519_tpu_torch.utils import rng as trng
from curve25519_tpu_torch.utils.interop import to_numpy

from test_torch_ladder_host import jax_host_core

# the carriers default to the card: these tests ask for the CPU
from_numpy = functools.partial(interop.from_numpy, device="cpu")

# the padding edges: one block holds up to 111 bytes, two up to 239
EDGE_LENGTHS = [0, 1, 111, 112, 127, 128, 129, 239, 240, 255, 256]
# the pieces of a streamed message: empty, short, and across block edges
PIECES = [0, 1, 127, 128, 129, 255, 256]

_jax_sha = jax.jit(jsha.sha512)


@pytest.fixture(scope="module", autouse=True)
def _free_xla_executables():
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(512)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    return build.load_host(build.build_host())


def digests(t):
    return [bytes(r) for r in to_numpy(t).reshape(-1, 64)]


def test_padding_edges_equal_hashlib_and_jax(rng):
    msg = rng.integers(0, 256, (len(EDGE_LENGTHS), 256), dtype=np.uint8)
    lengths = np.array(EDGE_LENGTHS, np.int32)
    got = sha512.sha512(from_numpy(msg), from_numpy(lengths))
    assert got.shape == (len(EDGE_LENGTHS), 64) and got.dtype == torch.uint8
    assert digests(got) == [hashlib.sha512(m[:n].tobytes()).digest()
                            for m, n in zip(msg, EDGE_LENGTHS)]
    np.testing.assert_array_equal(to_numpy(got),
                                  np.asarray(_jax_sha(msg, lengths)))
    # a message of exactly L bytes needs no length argument; rank-1 is one call
    one = sha512.sha512(from_numpy(msg[3, :127]))
    assert bytes(to_numpy(one)) == hashlib.sha512(msg[3, :127].tobytes()).digest()
    # the length buckets of ragged batches start at the same edges
    lengths = EDGE_LENGTHS + [1000, 1200]
    for n in lengths:
        assert bucketing.nblocks(n) == jbucketing.nblocks(n), n
    for nb in range(1, 11):
        assert bucketing.bucket_length(nb) == jbucketing.bucket_length(nb)
    got, want = (bucketing.bucket_indices(lengths),
                 jbucketing.bucket_indices(lengths))
    assert list(got) == list(want)
    for nb in want:
        np.testing.assert_array_equal(got[nb], want[nb])
    for device in (None, "cpu"):
        _check_stream(rng, device)


def _check_stream(rng, device):
    """Sha512(device=device) over uneven pieces equals hashlib and the JAX
    package's Sha512, and holds O(1) state: a tail under one block, the
    exact byte count, and (on the host core) one fixed-size context."""
    data = rng.bytes(sum(PIECES))
    jax_host_core()                 # JAX's Sha512 then runs on its host core
    h, jh = sha512.Sha512(device=device), jsha.Sha512()
    ofs = 0
    for n in PIECES:
        h.update(data[ofs:ofs + n])
        jh.update(data[ofs:ofs + n])
        ofs += n
        assert len(h._tail) < 128
        if device is None:
            assert h._native.ctx_size == bindings.Sha512Stream().ctx_size
        assert h._total == ofs
    assert h.final() == jh.final() == hashlib.sha512(data).digest()
    for n in (111, 112, 239):                     # the padding edges
        assert sha512.Sha512(device=device).update(data[:n]).final() == \
            hashlib.sha512(data[:n]).digest()


@pytest.mark.parametrize("plen", [32, 64])
def test_prefix_and_ragged_lengths_equal_jax(rng, plen):
    msg = rng.integers(0, 256, (6, 200), dtype=np.uint8)
    prefix = rng.integers(0, 256, (6, plen), dtype=np.uint8)
    lengths = np.array([0, 1, 47, 48, 111, 200], np.int32)
    got = sha512.sha512(from_numpy(msg), from_numpy(lengths),
                        prefix=from_numpy(prefix))
    want = np.asarray(_jax_sha(msg, lengths, prefix=prefix))
    np.testing.assert_array_equal(to_numpy(got), want)
    assert digests(got)[2] == hashlib.sha512(
        prefix[2].tobytes() + msg[2, :47].tobytes()).digest()
    # one prefix broadcast over the batch == the explicit broadcast
    shared = sha512.sha512(from_numpy(msg), from_numpy(lengths),
                           prefix=from_numpy(prefix[0]))
    again = sha512.sha512(from_numpy(msg), from_numpy(lengths),
                          prefix=from_numpy(np.broadcast_to(prefix[0],
                                                            prefix.shape)))
    assert torch.equal(shared, again)


def test_pack_words_equal_jax(rng):
    msg = rng.integers(0, 256, (5, 150), dtype=np.uint8)
    lengths = np.array([0, 3, 80, 149, 150], np.int32)
    prefix = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    for pre in (None, prefix):
        words, nblocks, nb = sha512.pack_words(
            from_numpy(msg), from_numpy(lengths),
            None if pre is None else from_numpy(pre))
        jw, jnbl, jnb = jshk._pack_words(
            jnp.asarray(msg), jnp.asarray(lengths),
            None if pre is None else jnp.asarray(pre))
        assert nb == jnb
        np.testing.assert_array_equal(to_numpy(words),
                                      np.asarray(jw).view(np.int32))
        np.testing.assert_array_equal(to_numpy(nblocks), np.asarray(jnbl))
    _check_apply_bucketed_forms_and_trees(rng)


def _check_apply_bucketed_forms_and_trees(rng):
    """A list and a (padded, lengths) pair of the same rows give the same
    scatter; tuple and dict results keep their structure."""
    lens = [130, 0, 7, 111, 112]
    msgs = [rng.bytes(n) for n in lens]
    padded = np.zeros((len(msgs), 140), np.uint8)
    for i, m in enumerate(msgs):
        padded[i, :len(m)] = np.frombuffer(m, np.uint8)
        padded[i, len(m):] = 0xA5                   # bytes past the length
    rows = torch.arange(len(msgs), dtype=torch.int32)
    calls = []

    def fn(m, l, r):
        calls.append(m.shape)
        return {"digest": sha512.sha512(m, l), "pair": (r, l)}

    for form in (msgs, (padded, np.array(lens)),
                 (torch.from_numpy(padded), torch.tensor(lens))):
        calls.clear()
        out = bucketing.apply_bucketed(fn, form, rows)
        assert sorted(calls) == [(2, 239), (3, 111)]
        assert torch.equal(out["pair"][0], rows)
        assert out["pair"][1].tolist() == lens
        for i, m in enumerate(msgs):
            assert bytes(out["digest"][i].tolist()) == \
                hashlib.sha512(m).digest()


def test_host_kernel_equals_plain_and_hashlib(lib, rng):
    """sha512_host lane by lane (staged = 0) and through the kernel's warp
    staging (staged = 1: 32 lanes at a time, the last warp partial) on the
    padding edges and on 45 lanes of 0-600 bytes, whose block counts (1-5)
    differ inside each warp; then the packing kernel's host twin."""
    lengths = np.concatenate([EDGE_LENGTHS, [600, 0],
                              rng.integers(0, 601, 32)]).astype(np.int32)
    msg = rng.integers(0, 256, (len(lengths), 600), dtype=np.uint8)
    words, nblocks, _ = sha512.pack_words(from_numpy(msg),
                                          from_numpy(lengths))
    words = np.ascontiguousarray(to_numpy(words))
    nblocks = np.ascontiguousarray(to_numpy(nblocks))
    assert len(set(nblocks[:32])) > 1 and len(set(nblocks[32:])) > 1
    plain = sha512_kernel.sha512_blocks_plain(from_numpy(words),
                                              from_numpy(nblocks))
    for staged in (0, 1):
        out = np.zeros((len(msg), 64), np.uint8)
        lib.sha512_host(staged, out.ctypes.data, words.ctypes.data,
                        nblocks.ctypes.data, words.shape[1], len(msg))
        np.testing.assert_array_equal(out, to_numpy(plain),
                                      err_msg="staged=%d" % staged)
        assert [bytes(r) for r in out] == [
            hashlib.sha512(m[:n].tobytes()).digest()
            for m, n in zip(msg, lengths)]
    _check_pack_words_host(lib, rng)


def _hold_pack(lib, msg, lengths, prefix):
    """pack_words_host on numpy rows (any row stride, bytes contiguous)
    equals pack_words on their contiguous copies, word for word."""
    n, max_len = msg.shape
    plen = 0 if prefix is None else prefix.shape[1]
    words, nblocks, nb = sha512.pack_words(
        torch.from_numpy(np.ascontiguousarray(msg)),
        torch.from_numpy(np.ascontiguousarray(lengths)),
        None if prefix is None else torch.from_numpy(
            np.ascontiguousarray(prefix)))
    got_words = np.zeros((n, 32 * nb), np.int32)
    got_nblocks = np.zeros(n, np.int32)
    assert (max_len < 2 or msg.strides[1] == 1) and lengths.dtype == np.int32
    lib.pack_words_host(
        got_words.ctypes.data, got_nblocks.ctypes.data, msg.ctypes.data,
        msg.strides[0], max_len,
        None if prefix is None else prefix.ctypes.data,
        0 if prefix is None else prefix.strides[0], plen,
        lengths.ctypes.data, lengths.strides[0] // 4, 32 * nb, n)
    np.testing.assert_array_equal(got_words, words.numpy(),
                                  err_msg="L=%d P=%d" % (max_len, plen))
    np.testing.assert_array_equal(got_nblocks, nblocks.numpy())


def _check_pack_words_host(lib, rng):
    """The packing kernel's warps on the CPU (pack_words_host) against the
    plain pack_words: L of 1, 3, 130, 1,167 and 1,231 (L % 4 != 0) in rows
    that start 1 byte past a 4-byte boundary, every length 0..L for the
    small L and the block edges (111/112, 239/240, 943) for the large;
    prefixes of 0, 32 and 64 bytes, also off alignment; a message row, a
    prefix row and a length broadcast at stride 0."""
    for max_len in (1, 3, 130, 1167, 1231):
        if max_len <= 130:
            lengths = np.arange(max_len + 1)
        else:
            lengths = np.concatenate([[0, 1, 111, 112, 239, 240, 943,
                                       max_len - 1, max_len],
                                      rng.integers(0, max_len + 1, 7)])
        lengths = lengths.astype(np.int32)
        n = len(lengths)
        buf = rng.integers(0, 256, (n, (max_len + 4) // 4 * 4),
                           dtype=np.uint8)
        msg = buf[:, 1:1 + max_len]
        assert buf.ctypes.data % 4 == 0 and buf.strides[0] % 4 == 0
        for plen in (0, 32, 64):
            prefix = rng.integers(0, 256, (n, plen + 4),
                                  dtype=np.uint8)[:, 2:2 + plen]
            _hold_pack(lib, msg, lengths, prefix if plen else None)
        _hold_pack(lib, np.broadcast_to(msg[1], msg.shape), lengths,
                   np.broadcast_to(prefix[0], prefix.shape))
        _hold_pack(lib, msg, np.broadcast_to(lengths[-1], lengths.shape),
                   None)


def test_sha512_bytes_and_the_device_rule(monkeypatch):
    assert sha512.sha512_bytes(b"abc", device="cpu") == hashlib.sha512(
        b"abc").digest()
    assert sha512.sha512_bytes(b"", device="cpu") == hashlib.sha512().digest()
    with pytest.raises(ValueError):
        sha512.sha512(torch.zeros(2, 8, dtype=torch.uint8),
                      prefix=torch.zeros(2, 6, dtype=torch.uint8))
    if not torch.cuda.is_available():
        # bytes with no device and no card: never a silent CPU run
        with pytest.raises(RuntimeError):
            sha512.sha512_bytes(b"abc")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            bucketing.apply_bucketed(lambda m, l: l, [b"ab"])
    _check_rng_equals_jax(monkeypatch)


def _check_rng_equals_jax(monkeypatch):
    """get_random_bytes(n) with os.urandom and time.time fixed equals the
    JAX package's on the same pool key, counter and inputs."""
    jax_host_core()
    state = {}

    def urandom(k):
        state["i"] = state.get("i", 0) + 1
        return bytes((state["i"] * 7 + j) % 256 for j in range(k))

    monkeypatch.setattr(os, "urandom", urandom)
    monkeypatch.setattr("time.time", lambda: 1_700_000_000.25)
    for n in (1, 64, 100):
        state.clear()
        got = trng.get_random_bytes(n)
        state.clear()
        assert got == jrng.get_random_bytes(n), n
        assert len(got) == n
