"""Batched SHA-512 on ``[..., L]`` uint8 tensors (counterpart of
curve25519_tpu/ops/sha512.py and of the host side of
curve25519_tpu/ops/pallas/sha512_kernel.py).

Variable-length messages live in fixed-shape padded byte tensors with a
per-message length. ``pack_words`` applies the FIPS 180-4 padding in the
32-bit word domain (the counterpart of the TPU package's ``_pack_words``):
bytes are packed to big-endian words first, then the 0x80 marker, the zero
fill and the 128-bit length field are set per word with masks. A
``prefix`` (P bytes, P % 4 == 0, all live) is prepended in the word domain.
The compression runs in ops/cuda/sha512_kernel.py: the CUDA kernel for a
CUDA device, its plain version on the CPU. ``Sha512`` is the streaming
Init/Update/Final facade for one long host-side stream.

Words are int32 tensors that hold the bits of the big-endian uint32 words
(torch has no uint32 arithmetic on the CPU).
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from curve25519_tpu_torch.ops.cuda import (
    as_bytes, flatten_batch, pick_device, sha512_kernel,
)

__all__ = ["sha512", "sha512_plain", "sha512_bytes", "pack_words",
           "nblocks_static", "Sha512", "DIGEST_LEN", "BLOCK_LEN"]

DIGEST_LEN = 64
BLOCK_LEN = 128


def nblocks_static(max_len):
    """SHA-512 blocks of a max_len-byte message (padding included)."""
    return (max_len + 17 + BLOCK_LEN - 1) // BLOCK_LEN


def _u32(v):
    return v - (1 << 32) if v >> 31 else v


# Per word with r live bytes left (index min(max(r, -1), 4) + 1): the mask
# that keeps the live bytes, and the 0x80 marker right after them.
_KEEP = [0, 0, 0xFF000000, 0xFFFF0000, 0xFFFFFF00, 0xFFFFFFFF]
_MARK = [0, 0x80000000, 0x00800000, 0x00008000, 0x00000080, 0]


@functools.lru_cache(maxsize=None)
def _masks(device):
    return (torch.tensor([_u32(v) for v in _KEEP], dtype=torch.int32,
                         device=device),
            torch.tensor([_u32(v) for v in _MARK], dtype=torch.int32,
                         device=device))


def _pack4(x):
    """[B, 4k] uint8 -> [B, k] int32 big-endian words."""
    b = x.reshape(x.shape[0], -1, 4).to(torch.int32)
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def pack_words(msg, length, prefix=None):
    """FIPS 180-4 padding in the word domain.

    msg: [B, L] uint8; length: [B] int32 live bytes of msg; prefix:
    optional [B, P] uint8 (P % 4 == 0, all live) logically prepended.
    Returns (words [B, nb*32] int32 big-endian half-words (hi, lo) in block
    order, nblocks [B] int32 active blocks, nb)."""
    b, max_len = msg.shape
    plen = 0 if prefix is None else prefix.shape[-1]
    if plen % 4:
        raise ValueError("prefix length must be a multiple of 4, got %d"
                         % plen)
    nb = nblocks_static(max_len + plen)
    nw = nb * 32
    length = length.to(torch.int32) + plen            # whole-stream length

    max4 = (max_len + 3) // 4 * 4
    parts = [] if prefix is None else [_pack4(prefix)]
    parts.append(_pack4(F.pad(msg, (0, max4 - max_len))))
    tail = nw - plen // 4 - max4 // 4
    if tail > 0:
        parts.append(msg.new_zeros((b, tail), dtype=torch.int32))
    raw = torch.cat(parts, -1)[:, :nw]

    widx = torch.arange(nw, dtype=torch.int32, device=msg.device)
    sel = ((length[:, None] - 4 * widx).clamp(-1, 4) + 1).long()
    keep, mark = _masks(msg.device)
    words = (raw & keep[sel]) | mark[sel]

    # 128-bit big-endian bit length in the last two half-words of the final
    # active block (the low 64 bits; int32 lengths give < 2^34 bits)
    nblocks = (length + 17 + BLOCK_LEN - 1) // BLOCK_LEN
    last = nblocks[:, None] * 32
    bitlen_hi = (length >> 29)[:, None]
    bitlen_lo = (length.to(torch.int64) << 3).to(torch.int32)[:, None]
    words = torch.where(widx == last - 2, bitlen_hi, words)
    words = torch.where(widx == last - 1, bitlen_lo, words)
    return words, nblocks, nb


def _sha512(msg, length, prefix, device, blocks):
    dev = pick_device(msg, prefix, length, device=device)
    msg = as_bytes(msg, "msg", None, dev)
    batch = msg.shape[:-1]
    if prefix is not None:
        prefix = as_bytes(prefix, "prefix", None, dev)
        batch = torch.broadcast_shapes(batch, prefix.shape[:-1])
    max_len = msg.shape[-1]
    if length is None:
        length = torch.full(batch, max_len, dtype=torch.int32, device=dev)
    else:
        if isinstance(length, torch.Tensor) and length.device != msg.device:
            raise ValueError("length is on %s, msg on %s"
                             % (length.device, msg.device))
        length = torch.as_tensor(length, dtype=torch.int32, device=dev)
        batch = torch.broadcast_shapes(batch, length.shape)
    n, unflatten = flatten_batch(batch)
    msg = msg.expand(batch + (max_len,)).reshape(n, max_len)
    if prefix is not None:
        prefix = prefix.expand(batch + prefix.shape[-1:]).reshape(n, -1)
    words, nblocks, _ = pack_words(msg, length.expand(batch).reshape(n),
                                   prefix)
    return unflatten(blocks(words, nblocks))


def sha512(msg, length=None, prefix=None, device=None):
    """Batched SHA-512: [..., 64] uint8 digests of msg [..., L] uint8 with
    per-message byte lengths `length` [...] int32 (default L everywhere)
    and an optional `prefix` [..., P] uint8 (P % 4 == 0) hashed in front of
    each message. Batch axes broadcast. Device rule of ops/cuda."""
    return _sha512(msg, length, prefix, device, sha512_kernel.sha512_blocks)


def sha512_plain(msg, length=None, prefix=None, device=None):
    """sha512 through the plain compression on any device (the reference
    that the kernel is held against)."""
    return _sha512(msg, length, prefix, device,
                   sha512_kernel.sha512_blocks_plain)


def sha512_bytes(data, device=None):
    """SHA-512 of one byte string through the batched path; returns bytes."""
    arr = np.frombuffer(bytes(data), np.uint8).reshape(1, -1)
    out = sha512(arr, device=device)
    return bytes(out[0].cpu().tolist())


class Sha512:
    """Streaming SHA-512 (Init/Update/Final, the reference API shape) in
    O(1) memory: between calls it holds the 8-word state, a tail of fewer
    than 128 bytes and the exact byte count as a Python int, from which
    final() builds the 128-bit length field, so any stream length works.

    ``Sha512()`` runs on the port's host core (native/, built with g++ at
    first use; a failed build raises). ``Sha512(device=...)`` runs the
    whole blocks through the plain compression of ops/cuda/sha512_kernel on
    that device, at most _CHUNK_BLOCKS blocks moved there at a time. The
    host is the default, unlike the batched entry points, because one
    stream is a serial chain of blocks: the batched kernel starts every lane
    from the IV and cannot resume a state, and the plain compression costs
    thousands of small launches per block on a card (each int64 operation
    of the 80 rounds is one)."""

    _CHUNK_BLOCKS = 512

    def __init__(self, device=None):
        self._total = 0
        self._tail = bytearray()
        if device is None:
            from curve25519_tpu_torch.native import bindings
            self._native = bindings.Sha512Stream()
            self._state = None
        else:
            self._native = None
            h0, _ = sha512_kernel._consts(pick_device(device=device))
            self._state = h0.clone()                          # [8] int64

    def update(self, data):
        data = bytes(data)
        self._total += len(data)
        if self._native is not None:
            self._native.update(data)
            return self
        self._tail += data
        nfull = len(self._tail) // BLOCK_LEN * BLOCK_LEN
        if nfull:
            self._absorb(bytes(self._tail[:nfull]))
            del self._tail[:nfull]
        return self

    def _absorb(self, block_bytes):
        """Compress whole blocks into the state, one block after another."""
        words = np.frombuffer(block_bytes, ">i8").astype(np.int64)
        words = words.reshape(-1, 16)
        st = list(self._state[:, None])                       # 8 x [1]
        for ofs in range(0, words.shape[0], self._CHUNK_BLOCKS):
            chunk = torch.from_numpy(words[ofs:ofs + self._CHUNK_BLOCKS]).to(
                self._state.device)
            for blk in chunk:
                st = sha512_kernel._compress(st, list(blk[:, None]))
        self._state = torch.cat(st)

    def final(self) -> bytes:
        if self._native is not None:
            return self._native.final()
        # FIPS 180-4 padding from the exact host-side length
        fill = self._total % BLOCK_LEN
        padlen = (112 - fill) if fill < 112 else (240 - fill)
        self._absorb(bytes(self._tail) + b"\x80" + bytes(padlen - 1)
                     + (self._total * 8).to_bytes(16, "big"))
        self._tail.clear()
        return b"".join((v & (2**64 - 1)).to_bytes(8, "big")
                        for v in self._state.tolist())
