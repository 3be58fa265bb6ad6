"""Twisted-Edwards point arithmetic in extended homogeneous coordinates on
limb tensors (counterpart of curve25519_tpu/models/edwards.py).

Curve: -x^2 + y^2 = 1 + d x^2 y^2 over GF(2^255-19) (a = -1).

- Ext point:  dict(x, y, z, t)            with T = X*Y/Z
- PE point:   dict(ypx, ymx, t2d, z2)     = (Y+X, Y-X, 2d*T, 2Z)
- PA point:   dict(ypx, ymx, t2d)         affine (Z = 1)

The folding base-point multiply is a Python loop of (double +
constant-time table add) over the fold digits with a randomized projective
start. With the epilogues of ops/cuda/edwards_kernel.py it is the plain
version of the CUDA base-multiply kernel (csrc/basemult.cu), whose device
code (csrc/edwards25519.cuh) keeps the same op order.

Verify's point code lives here too: decompression (``calculate_x``,
``unpack_point``, the JAX package's models/ed25519.py:50-73, re-exported by
models/ed25519.py), compression (``pack``, its ``_pack``) and the
double-scalar multiply s*G + h*(-Q) (``poly_point_mult``, its
``_poly_point_multiply``), which with ``pack`` is the plain version of the
CUDA poly kernels (csrc/verify.cu).
"""

import torch

from curve25519_tpu_torch.config import ED_2D, ED_D, ED_DI
from curve25519_tpu_torch.models import tables
from curve25519_tpu_torch.ops import codec, fe

__all__ = [
    "double", "add_pe", "add_pa", "to_pe", "to_affine", "base_point_mult",
    "base_point_mult_fold4", "identity_ext", "calculate_x", "unpack_point",
    "pack", "poly_point_mult",
]


def identity_ext(shape=(), device=None):
    return {"x": fe.zero(shape, device), "y": fe.one(shape, device),
            "z": fe.one(shape, device), "t": fe.zero(shape, device)}


def double(p):
    """P = 2*P (4M + 4S)."""
    a = fe.sqr(p["x"])
    b = fe.sqr(p["y"])
    c = fe.sqr(p["z"])
    c = fe.add(c, c)
    d = fe.neg(a)                       # D = -A
    h = fe.sub(d, b)                    # H = D - B = -(A+B)
    g = fe.add(d, b)                    # G = D + B = B - A
    f = fe.sub(g, c)                    # F = G - C
    e = fe.sqr(fe.add(p["x"], p["y"]))
    e = fe.add(e, h)                    # E = (X+Y)^2 - A - B
    return {"x": fe.mul(e, f), "y": fe.mul(h, g),
            "z": fe.mul(g, f), "t": fe.mul(e, h)}


def add_pe(p, q):
    """P + Q for Q in PE form (8M)."""
    a = fe.mul(fe.sub(p["y"], p["x"]), q["ymx"])
    b = fe.mul(fe.add(p["y"], p["x"]), q["ypx"])
    c = fe.mul(p["t"], q["t2d"])
    d = fe.mul(p["z"], q["z2"])
    e = fe.sub(b, a)                    # E = B - A
    h = fe.add(b, a)                    # H = B + A
    f = fe.sub(d, c)                    # F = D - C
    g = fe.add(d, c)                    # G = D + C
    return {"x": fe.mul(e, f), "y": fe.mul(h, g),
            "z": fe.mul(g, f), "t": fe.mul(e, h)}


def add_pa(p, q):
    """P + Q for affine precomputed Q (7M)."""
    a = fe.mul(fe.sub(p["y"], p["x"]), q["ymx"])
    b = fe.mul(fe.add(p["y"], p["x"]), q["ypx"])
    c = fe.mul(p["t"], q["t2d"])
    d = fe.add(p["z"], p["z"])          # D = 2*Z1 (Z2 = 1)
    e = fe.sub(b, a)
    h = fe.add(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    return {"x": fe.mul(e, f), "y": fe.mul(h, g),
            "z": fe.mul(g, f), "t": fe.mul(e, h)}


def to_pe(p):
    """Ext -> PE form."""
    return {"ypx": fe.add(p["y"], p["x"]),
            "ymx": fe.sub(p["y"], p["x"]),
            "t2d": fe.mul(p["t"], fe.from_int(ED_2D, device=p["t"].device)),
            "z2": fe.add(p["z"], p["z"])}


def to_affine(p):
    """Normalize to affine (x, y) limb tensors (one inverse)."""
    zi = fe.inv(p["z"])
    return fe.mul(p["x"], zi), fe.mul(p["y"], zi)


def _base_mult_folded(cut, zr, gather_fn):
    """Seed the accumulator from digit 0 with the randomized projective
    start (2xR : 2yR : 2R : 2xyR), then (double + table add) over the
    remaining digits."""
    if zr is None:
        zr = fe.one(device=cut.device)
    p0 = gather_fn(cut[..., 0])
    x = fe.sub(p0["ypx"], p0["ymx"])            # 2x
    y = fe.add(p0["ypx"], p0["ymx"])            # 2y
    t = fe.mul(p0["t2d"], fe.from_int(ED_DI, device=cut.device))  # 2xy
    s = {"x": fe.mul(x, zr), "y": fe.mul(y, zr),
         "z": fe.add(zr, zr), "t": fe.mul(t, zr)}
    for i in range(1, cut.shape[-1]):
        s = add_pa(double(s), gather_fn(cut[..., i]))
    return s


def base_point_mult(cut, zr=None):
    """S = a*G via folding-8: 31 x (double + constant-time table add) over
    [..., 32] 8-fold digits (ops/fold.cut8_*). zr: optional nonzero field
    element randomizing the projective start. Returns an Ext point."""
    return _base_mult_folded(cut, zr, tables.gather_pa)


def base_point_mult_fold4(cut, zr=None):
    """S = a*G via folding-4: 63 x (double + table add) over [..., 64]
    4-fold digits (ops/fold.cut4_*) against the 16-entry table."""
    return _base_mult_folded(cut, zr, tables.gather_pa4)


def calculate_x(y, parity):
    """x from y with the given parity bit, and ok where (y^2 - 1)/(d y^2 + 1)
    is a square (reference ed25519_CalculateX). A y >= p is taken mod p, and
    x = 0 takes either parity."""
    one = fe.one(y.shape[:-1], y.device)
    y2 = fe.sqr(y)
    u = fe.sub(y2, one)
    v = fe.add(fe.mul(y2, fe.from_int(ED_D, device=y.device)), one)
    x, ok = fe.sqrt_ratio(u, v)
    xc = fe.canon(x)
    flip = ((xc[..., 0] ^ parity) & 1) == 1
    return fe.select(flip, fe.neg(xc), xc), ok


def unpack_point(p_bytes, negate=False):
    """[..., 32] uint8 compressed point -> (Ext point, ok). negate=True gives
    -Q (the parity flipped), the form a verify context holds."""
    y_bytes, parity = codec.unpack_parity(p_bytes)
    if negate:
        parity = 1 - parity
    y = fe.from_bytes(y_bytes)
    x, ok = calculate_x(y, parity)
    return {"x": x, "y": y, "z": fe.one(y.shape[:-1], y.device),
            "t": fe.mul(x, y)}, ok


def pack(x, y):
    """Affine limbs -> [..., 32] uint8 compressed point (enc(y), x's parity
    in bit 255)."""
    return codec.pack_point(fe.to_bytes(y), fe.canon(x)[..., 0] & 1)


def poly_point_mult(u, v, planes):
    """R' = s*G + h*(-Q) as affine (x, y): the 32 8-fold digits u of s
    against the folding-8 table interleaved with the 64 4-fold digits v of h
    against the q_table planes (tables.gather_pe; [..., 16, 160] per lane or
    one [16, 160] for all): 31 x (double + PE add), then 32 x (double + PA
    add + PE add) (reference edp_PolyPointMultiply)."""
    planes = planes.to(torch.float64)            # converted once for 63 reads
    q0 = tables.gather_pe(v[..., 0], planes)
    s = {"x": fe.sub(q0["ypx"], q0["ymx"]), "y": fe.add(q0["ypx"], q0["ymx"]),
         "z": q0["z2"],
         "t": fe.mul(q0["t2d"], fe.from_int(ED_DI, device=u.device))}
    for i in range(1, 32):
        s = add_pe(double(s), tables.gather_pe(v[..., i], planes))
    for i in range(32):
        s = add_pa(double(s), tables.gather_pa(u[..., i]))
        s = add_pe(s, tables.gather_pe(v[..., 32 + i], planes))
    return to_affine(s)
