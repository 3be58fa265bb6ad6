"""Wrapper of the CUDA SHA-512 kernel (csrc/sha512.cu), the counterpart of
curve25519_tpu/ops/pallas/sha512_kernel.py, and its plain version.

Both take FIPS 180-4 padded messages as built by ops/sha512.pack_words:
``words`` [n, nb*32] int32 big-endian half-words (hi, lo) per 64-bit word,
block after block, and ``nblocks`` [n] int32 active blocks per lane; both
return the [n, 64] uint8 digests. ``sha512_blocks`` launches the kernel for
CUDA tensors (or raises) and runs ``sha512_blocks_plain`` for CPU tensors.
``launches`` counts kernel launches.

``pack_words`` launches the packing kernel of the same library, which
ops/sha512.pack_words takes for CUDA tensors (its PyTorch code is the plain
version); ``pack_launches`` counts its launches.
"""

import functools
import math

import torch

from curve25519_tpu_torch.ops.cuda import build, use_cuda

__all__ = ["sha512_blocks", "sha512_blocks_plain", "pack_words",
           "launches", "pack_launches"]

launches = 0
pack_launches = 0


def _primes(n):
    ps, c = [], 2
    while len(ps) < n:
        if all(c % p for p in ps):
            ps.append(c)
        c += 1
    return ps


def _icbrt(n):
    x = int(round(n ** (1 / 3))) + 2
    while x * x * x > n:
        x -= 1
    while (x + 1) ** 3 <= n:
        x += 1
    return x


# FIPS 180-4 constants from first principles (fractional parts of the square
# and cube roots of the first primes), as in the JAX ops/sha512.py
H0 = [math.isqrt(p << 128) & ((1 << 64) - 1) for p in _primes(8)]
K = [_icbrt(p << 192) & ((1 << 64) - 1) for p in _primes(80)]
assert H0[0] == 0x6A09E667F3BCC908 and H0[7] == 0x5BE0CD19137E2179
assert K[0] == 0x428A2F98D728AE22 and K[79] == 0x6C44198C4A475817


def _i64(v):
    """A 64-bit word as the int64 with the same bits."""
    return v - (1 << 64) if v >> 63 else v


@functools.lru_cache(maxsize=None)
def _consts(device):
    return (torch.tensor([_i64(v) for v in H0], device=device),
            torch.tensor([_i64(v) for v in K], device=device))


# 64-bit words live in int64, where + wraps like uint64 and the bit
# operators act on the same bits; the right shifts are made logical with a
# mask (torch has no uint64 arithmetic on the CPU).
def _shr(x, n):
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x, n):
    return _shr(x, n) | (x << (64 - n))


def _compress(st, w):
    """80 rounds over one block: st and w are lists of 8 and 16 [n] int64
    tensors; returns the new state list (state + working variables)."""
    _, k = _consts(st[0].device)
    a, b, c, d, e, f, g, h = st
    w = list(w)
    for t in range(80):
        if t >= 16:
            w2, w15 = w[(t - 2) % 16], w[(t - 15) % 16]
            s1 = _rotr(w2, 19) ^ _rotr(w2, 61) ^ _shr(w2, 6)
            s0 = _rotr(w15, 1) ^ _rotr(w15, 8) ^ _shr(w15, 7)
            w[t % 16] = w[t % 16] + s1 + w[(t - 7) % 16] + s0
        t1 = (h + (_rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41))
              + ((e & f) ^ (~e & g)) + k[t] + w[t % 16])
        t2 = (_rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)) + ((a & b) ^ (a & c)
                                                            ^ (b & c))
        a, b, c, d, e, f, g, h = t1 + t2, a, b, c, d + t1, e, f, g
    return [s + v for s, v in zip(st, (a, b, c, d, e, f, g, h))]


def sha512_blocks_plain(words, nblocks):
    """The plain version: a loop over the blocks of all lanes at once,
    where blocks past a lane's count leave its state unchanged."""
    n, nw = words.shape
    w64 = (words[:, 0::2].to(torch.int64) << 32) | (
        words[:, 1::2].to(torch.int64) & 0xFFFFFFFF)          # [n, nw // 2]
    h0, _ = _consts(words.device)
    st = [h0[i].expand(n) for i in range(8)]
    for blk in range(nw // 32):
        new = _compress(st, [w64[:, 16 * blk + t] for t in range(16)])
        active = blk < nblocks
        st = [torch.where(active, nv, ov) for nv, ov in zip(new, st)]
    state = torch.stack(st, -1)                               # [n, 8]
    shifts = torch.arange(56, -8, -8, device=words.device)
    return ((state[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(n, 64)


def sha512_blocks(words, nblocks):
    """Digests [n, 64] uint8 of padded word rows: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    global launches
    n, nw = words.shape
    if (words.dtype != torch.int32 or nw % 32 or nblocks.dtype != torch.int32
            or nblocks.shape != (n,) or nblocks.device != words.device):
        raise ValueError("words must be [n, 32k] int32 and nblocks [n] int32 "
                         "on one device, got %s %s and %s %s"
                         % (tuple(words.shape), words.dtype,
                            tuple(nblocks.shape), nblocks.dtype))
    if not use_cuda(words):
        return sha512_blocks_plain(words, nblocks)
    words, nblocks = words.contiguous(), nblocks.contiguous()
    if words.data_ptr() % 16:       # the kernel copies 16-byte pieces
        words = words.clone()
    out = torch.empty((n, 64), dtype=torch.uint8, device=words.device)
    build.launch("sha512", "sha512_launch", words.device, out.data_ptr(),
                 words.data_ptr(), nblocks.data_ptr(), nw, n, n=n)
    launches += 1
    return out


def pack_words(msg, length, prefix, nw):
    """(words [n, nw] int32, nblocks [n] int32) of the FIPS 180-4 padded
    streams prefix || msg[:length] by the CUDA kernel, in the layout of
    ops/sha512.pack_words: msg [n, L] uint8 and prefix None or [n, P] uint8
    (P % 4 == 0) on one card, rows at any stride (0 broadcasts one row),
    length [n] int32 live bytes of msg."""
    global pack_launches
    n, max_len = msg.shape
    rows = [msg] if prefix is None else [msg, prefix]
    if (not msg.is_cuda or 4 * nw >= 1 << 31 or length.shape != (n,)
            or length.device != msg.device
            or any(r.dtype != torch.uint8 or r.shape[0] != n
                   or r.device != msg.device for r in rows)):
        raise ValueError("msg and prefix must be [n, k] uint8 and length [n] "
                         "on one card, got %s %s on %s and %s on %s"
                         % (tuple(msg.shape), msg.dtype, msg.device,
                            tuple(length.shape), length.device))
    # the kernel reads a row's bytes in order; rows may have any stride
    rows = [r.contiguous() if r.shape[1] > 1 and r.stride(1) != 1 else r
            for r in rows]
    length = length.to(torch.int32)
    words = torch.empty((n, nw), dtype=torch.int32, device=msg.device)
    nblocks = torch.empty((n,), dtype=torch.int32, device=msg.device)
    pre = (None, 0, 0) if prefix is None else (
        rows[1].data_ptr(), rows[1].stride(0), rows[1].shape[1])
    build.launch("sha512", "pack_words_launch", msg.device, words.data_ptr(),
                 nblocks.data_ptr(), rows[0].data_ptr(), rows[0].stride(0),
                 max_len, *pre, length.data_ptr(), length.stride(0), nw, n,
                 n=n)
    pack_launches += 1
    return words, nblocks
