"""Constant-time Montgomery XZ ladder on curve25519 in plain PyTorch
(counterpart of curve25519_tpu/models/montgomery.py).

This is the plain version of the CUDA ladder kernel (ops/cuda/csrc/ladder.cu):
a Python loop over key bits 253..0 of branch-free field ops on the whole
batch. Clamped keys always have bit 254 set, so the ladder starts at k = 1
with the Z-randomized point P = (u*zr : zr) and runs a fixed 254 steps. One
step costs 5M + 4S + 1 small-constant multiply.
"""

import torch

from curve25519_tpu_torch.config import A24
from curve25519_tpu_torch.ops import codec, fe

__all__ = ["ladder", "point_multiply"]


def _ladder_step(x2, z2, x3, z3, u, bit):
    """(P, Q) -> (2P, P+Q) with conditional swap by the key bit."""
    swap = bit == 1
    x2, x3 = fe.select(swap, x3, x2), fe.select(swap, x2, x3)
    z2, z3 = fe.select(swap, z3, z2), fe.select(swap, z2, z3)

    a = fe.add(x2, z2)
    aa = fe.sqr(a)
    b = fe.sub(x2, z2)
    bb = fe.sqr(b)
    e = fe.sub(aa, bb)
    c = fe.add(x3, z3)
    d = fe.sub(x3, z3)
    da = fe.mul(d, a)
    cb = fe.mul(c, b)
    x3n = fe.sqr(fe.add(da, cb))
    z3n = fe.mul(u, fe.sqr(fe.sub(da, cb)))
    x2n = fe.mul(aa, bb)
    z2n = fe.mul(e, fe.mul_small_add(aa, A24, e))

    x2o, x3o = fe.select(swap, x3n, x2n), fe.select(swap, x2n, x3n)
    z2o, z3o = fe.select(swap, z3n, z2n), fe.select(swap, z2n, z3n)
    return x2o, z2o, x3o, z3o


def _mont_double(x, z):
    """(X : Z) -> 2*(X : Z)."""
    a = fe.add(x, z)
    b = fe.sub(x, z)
    aa = fe.sqr(a)
    bb = fe.sqr(b)
    x2 = fe.mul(aa, bb)
    e = fe.sub(aa, bb)
    z2 = fe.mul(e, fe.mul_small_add(aa, A24, e))
    return x2, z2


def ladder(u, k_bits, zr=None):
    """Scalar-multiply the point with x-coordinate ``u`` ([..., NLIMBS]
    limbs) by a clamped scalar given as bits ([..., 256] int32). Returns the
    affine x-coordinate limbs of k*P. ``zr`` (limbs, nonzero) randomizes the
    projective start and does not change the result; None means one."""
    if zr is None:
        zr = fe.one(device=u.device)
    batch = torch.broadcast_shapes(u.shape[:-1], k_bits.shape[:-1],
                                   zr.shape[:-1])
    u = u.expand(batch + u.shape[-1:])
    zr = zr.expand(batch + zr.shape[-1:])
    # k = 1 state, Z-randomized: (lo, hi) = (P, 2P), P = (u*zr : zr)
    lo_x, lo_z = fe.mul(u, zr), zr
    hi_x, hi_z = _mont_double(lo_x, lo_z)
    for i in range(253, -1, -1):
        lo_x, lo_z, hi_x, hi_z = _ladder_step(lo_x, lo_z, hi_x, hi_z, u,
                                              k_bits[..., i])
    return fe.mul(lo_x, fe.inv(lo_z))


def point_multiply(point_bytes, sk_bytes, zr=None):
    """Q = k*P from 32-byte encodings; returns the 32-byte x-coordinate.

    The secret key is clamped internally. Per RFC 7748 the top bit of the
    input u-coordinate is masked; a non-canonical u (>= p) is decoded
    unreduced."""
    sk = codec.clamp(sk_bytes)
    point_bytes = point_bytes.clone()
    point_bytes[..., 31] &= 0x7F
    u = fe.from_bytes(point_bytes)
    x = ladder(u, codec.scalar_bits(sk), zr=zr)
    return fe.to_bytes(x)
