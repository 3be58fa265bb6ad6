"""Wrappers of the fused CUDA keygen and sign kernels (csrc/sign.cu), the
counterpart of curve25519_tpu/ops/pallas/sign_kernel.py, and their plain
versions.

- ``keygen(sk, zr, bl, bp)``: [..., 32] seeds -> [..., 32] compressed
  public keys (SHA-512, clamp, fold cut, base multiply, pack), with the
  blinded form (a + bl)*G + BP when bl and bp are given.
- ``sign_fused(priv, msg, msg_len, zr, bl, bp)``: [..., 64] signatures of
  messages up to MAX_FUSED_BLOCKS SHA-512 blocks (max_fused_msg_len), in one
  launch.
- ``sign_composed(..., plain)``: the multi-launch composition of the same
  signature, for messages of any length: ops/sha512 twice, the mod-l steps
  of ops/sc, and the base multiply of edwards_kernel. With plain=True every
  part is the plain PyTorch version; that is ``sign_plain``, the plain
  version of the fused sign kernel, as ``keygen_plain`` is of keygen.

CUDA tensors launch the kernels (or raise); CPU tensors run the plain
versions. ``launches`` counts kernel launches per kernel.
"""

import torch

from curve25519_tpu_torch.config import NLIMBS
from curve25519_tpu_torch.ops import codec, fe, fold, sc, sha512
from curve25519_tpu_torch.ops.cuda import (
    as_limbs, build, edwards_kernel, flatten_batch, use_cuda,
)
from curve25519_tpu_torch.utils import profiling

__all__ = ["keygen", "keygen_plain", "sign_fused", "sign_composed",
           "sign_plain", "max_fused_msg_len", "MAX_FUSED_BLOCKS", "launches"]

# Longest message, in SHA-512 blocks of its 64-byte-prefixed h hash, that
# the fused sign takes (the TPU's VMEM budget; kept so both route alike).
MAX_FUSED_BLOCKS = 8

launches = {"keygen": 0, "sign": 0}


def max_fused_msg_len(msg_max_len):
    """True when [..., msg_max_len] messages fit the fused sign."""
    return sha512.nblocks_static(msg_max_len + 64) <= MAX_FUSED_BLOCKS


def _base_mult_pk(a, zr, bl, bp, mult):
    """enc(a*G), or enc((a + bl)*G + BP) when blinded; a: normalized limbs."""
    t = a if bl is None else sc.add(sc.mod(a), bl)
    return mult(fold.cut8_limbs(t), zr=zr, bp=bp, mode="pk")


def keygen_plain(sk, zr=None, bl=None, bp=None):
    """The plain version of the keygen kernel."""
    md = sha512.sha512_plain(sk)
    a = fe.from_bytes(codec.clamp(md[..., :32]))
    return _base_mult_pk(a, zr, bl, bp, edwards_kernel.base_mult_plain)


def sign_composed(priv, msg, msg_len, zr=None, bl=None, bp=None,
                  plain=False):
    """Signatures by the composition (any message length): r = SHA512(
    prefix || m) mod l, R = r*G, h = SHA512(R || pk || m) mod l,
    S = h*a + r. plain=False routes each part by device (kernels on a card);
    plain=True runs the plain versions."""
    sha = sha512.sha512_plain if plain else sha512.sha512
    mult = (edwards_kernel.base_mult_plain if plain
            else edwards_kernel.base_mult)
    batch = torch.broadcast_shapes(priv.shape[:-1], msg.shape[:-1],
                                   msg_len.shape)
    md = sha(priv[..., :32])
    a = fe.from_bytes(codec.clamp(md[..., :32]))
    r = sc.from_digest(sha(msg, msg_len,
                           prefix=md[..., 32:].expand(batch + (32,))))
    R = _base_mult_pk(r, zr, bl, bp, mult).expand(batch + (32,))
    h = sc.from_digest(sha(msg, msg_len, prefix=torch.cat(
        [R, priv[..., 32:].expand(batch + (32,))], -1)))
    s = sc.muladd(h, sc.mod(a), r)
    return torch.cat([R, sc.to_bytes(s)], -1)


def sign_plain(priv, msg, msg_len, zr=None, bl=None, bp=None):
    """The plain version of the fused sign kernel."""
    return sign_composed(priv, msg, msg_len, zr, bl, bp, plain=True)


def _blinding_rows(zr, bl, bp, batch, n, device):
    """[(rows, stride)] of zr, bl and bp for the kernels (see
    edwards_kernel.limb_rows)."""
    if (bl is None) != (bp is None):
        raise ValueError("bl and bp go together")
    with profiling.span("sign_kernel.blinding_rows"):
        pairs = [edwards_kernel.limb_rows(
            None if x is None else as_limbs(x, name, NLIMBS, device), batch,
            n) for name, x in (("zr", zr), ("bl", bl))]
        pairs.append(edwards_kernel.pe_rows(bp, batch, n, device))
    return pairs


def _pointers(pairs):
    args = []
    for rows, stride in pairs:
        args += [None if rows is None else rows.data_ptr(), stride]
    return args


def keygen(sk, zr=None, bl=None, bp=None):
    """Compressed public keys [..., 32] of seeds sk [..., 32] uint8: the
    fused CUDA kernel for a CUDA sk, keygen_plain for a CPU one."""
    if sk.dtype != torch.uint8 or sk.ndim < 1 or sk.shape[-1] != 32:
        raise ValueError("sk must be [..., 32] uint8, got %s %s"
                         % (tuple(sk.shape), sk.dtype))
    if not use_cuda(sk):
        return keygen_plain(sk, zr=zr, bl=bl, bp=bp)
    batch = sk.shape[:-1]
    n, unflatten = flatten_batch(batch)
    sk = sk.reshape(n, 32).contiguous()
    rows = _blinding_rows(zr, bl, bp, batch, n, sk.device)
    pk = torch.empty((n, 32), dtype=torch.uint8, device=sk.device)
    build.launch("sign", "keygen_launch", sk.device, pk.data_ptr(),
                 sk.data_ptr(), *_pointers(rows),
                 edwards_kernel.mma_word_table(sk.device).data_ptr(), n, n=n)
    launches["keygen"] += 1
    return unflatten(pk)


def sign_fused(priv, msg, msg_len, zr=None, bl=None, bp=None):
    """Signatures [batch, 64] in one launch: priv [..., 64] uint8 (seed ||
    pk), msg [..., L] uint8 with max_fused_msg_len(L), msg_len [...] int32.
    The fused CUDA kernel for CUDA tensors, sign_plain for CPU ones."""
    if (priv.dtype != torch.uint8 or priv.ndim < 1 or priv.shape[-1] != 64
            or msg.dtype != torch.uint8 or msg.ndim < 1
            or msg_len.dtype != torch.int32
            or not priv.device == msg.device == msg_len.device):
        raise ValueError("priv must be [..., 64] uint8, msg [..., L] uint8 and "
                         "msg_len [...] int32 on one device")
    if not max_fused_msg_len(msg.shape[-1]):
        raise ValueError("messages of %d bytes exceed the fused sign"
                         % msg.shape[-1])
    if not use_cuda(priv):
        return sign_plain(priv, msg, msg_len, zr=zr, bl=bl, bp=bp)
    batch = torch.broadcast_shapes(priv.shape[:-1], msg.shape[:-1],
                                   msg_len.shape)
    n, unflatten = flatten_batch(batch)
    L = msg.shape[-1]
    with profiling.span("sign_kernel.rows", n):
        priv = priv.expand(batch + (64,)).reshape(n, 64).contiguous()
        msg = msg.expand(batch + (L,)).reshape(n, L)
        msg_len = msg_len.expand(batch).reshape(n)
        # the message hashes with a zero hole for the in-kernel prefixes:
        # one zero row, broadcast (the packing kernel reads rows by stride)
        zero = msg.new_zeros(1, 64)
        hole2, hole3 = zero[:, :32].expand(n, 32), zero.expand(n, 64)
    w2, nb2, _ = sha512.pack_words(msg, msg_len, prefix=hole2)
    w3, nb3, _ = sha512.pack_words(msg, msg_len, prefix=hole3)
    rows = _blinding_rows(zr, bl, bp, batch, n, priv.device)
    sig = torch.empty((n, 64), dtype=torch.uint8, device=priv.device)
    build.launch("sign", "sign_launch", priv.device, sig.data_ptr(),
                 priv.data_ptr(), w2.data_ptr(), w2.shape[1], nb2.data_ptr(),
                 w3.data_ptr(), w3.shape[1], nb3.data_ptr(), *_pointers(rows),
                 edwards_kernel.mma_word_table(priv.device).data_ptr(), n,
                 n=n)
    launches["sign"] += 1
    return unflatten(sig)
