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
"""

from curve25519_tpu_torch.config import ED_2D, ED_DI
from curve25519_tpu_torch.models import tables
from curve25519_tpu_torch.ops import fe

__all__ = [
    "double", "add_pe", "add_pa", "to_pe", "to_affine", "base_point_mult",
    "base_point_mult_fold4", "identity_ext",
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
