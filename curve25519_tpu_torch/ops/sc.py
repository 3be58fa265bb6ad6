"""sc25519 — scalar arithmetic mod the base-point order
l = 2^252 + 27742317777372353535851937790883648493 (counterpart of
curve25519_tpu/ops/sc.py, the same integer steps on ``[..., 20]`` int32
limbs of radix 2^13).

Reduction is linear in the limbs: the high 20 limbs of a double-width value
fold down in one step through the constant matrix FOLD_SC, whose row i
holds the limbs of 2^(13*(20+i)) mod l. Canonicalization uses
l = 2^252 + delta (delta ~ 2^125): for V = q*2^252 + rem,
V - q*l = rem - q*delta, at worst one l-addition below zero.

All values handed between public ops are canonical (< l, normalized limbs).
These functions are also the plain version of the mod-l device code in
ops/cuda/csrc/sc25519.cuh, which keeps the same steps.
"""

import functools

import numpy as np
import torch

from curve25519_tpu_torch.config import BITS, ELL, MASK, NLIMBS, int_to_limbs
from curve25519_tpu_torch.ops import fe
from curve25519_tpu_torch.ops.cuda import as_bytes
from curve25519_tpu_torch.ops.fe import _carry_seq as _carry, _mul_cols
from curve25519_tpu_torch.utils import profiling

__all__ = ["from_int", "mod", "add", "neg", "sub_from_ell", "mul", "muladd",
           "from_bytes", "from_bytes_raw", "to_bytes", "below_l",
           "from_digest", "inv", "mont_mul", "to_mont", "from_mont",
           "exp_mod_bpo"]

_ELL_LIMBS = int_to_limbs(ELL)
_DELTA_LIMBS = int_to_limbs(ELL - 2**252)        # 125-bit delta

# FOLD_SC[i, j] = limb j of (2^(13*(20+i)) mod l)
_FOLD_SC = np.stack([
    int_to_limbs(pow(2, BITS * (NLIMBS + i), ELL)) for i in range(NLIMBS)
]).astype(np.int32)

# 2^260 mod l, for folding one carry-out limb at position 260
_R260 = int_to_limbs(pow(2, BITS * NLIMBS, ELL))

# from_digest gather tables: limb i of the 40-limb view holds bits
# [13i, 13i+13) of the 512-bit LE digest, inside the three bytes starting at
# (13i)//8 (the digest is padded to 66 bytes; bits past 511 read zeros)
_FD_J = np.array([(13 * i) // 8 for i in range(2 * NLIMBS)])
_FD_S = np.array([(13 * i) % 8 for i in range(2 * NLIMBS)], np.int32)

_TABLES = {"ell": _ELL_LIMBS, "delta": _DELTA_LIMBS, "fold_sc": _FOLD_SC,
           "r260": _R260, "fd_j": _FD_J, "fd_s": _FD_S}


@functools.lru_cache(maxsize=None)
def _const(name, device):
    v = _TABLES[name]
    dtype = torch.int64 if v.dtype == np.int64 else torch.int32
    return torch.as_tensor(v, dtype=dtype, device=device)


def _canon(d, c):
    """Canonicalize value = d + c*2^260 (d: normalized 20 limbs,
    0 <= c < 2^12) into [0, l)."""
    q = (d[..., 19] >> 5) + (c << 8)              # value >> 252
    dlow = torch.cat([d[..., :19], d[..., 19:] & 0x1F], -1)
    t = dlow - q[..., None] * _const("delta", d.device)
    td, tc = _carry(t, NLIMBS)
    ud, _ = _carry(td + _const("ell", d.device), NLIMBS)
    return torch.where((tc < 0)[..., None], ud, td)


def _reduce40(cols40):
    """Reduce 40 normalized-or-small columns (|col| < 2^30.4) mod l. The
    FOLD_SC contraction is a broadcast multiply and an int32 sum (integer
    matmul does not run on CUDA); every column stays below 2^31."""
    low, high = cols40[..., :NLIMBS], cols40[..., NLIMBS:]
    fold = (high[..., :, None] * _const("fold_sc", cols40.device))
    r = low + fold.sum(-2, dtype=torch.int32)
    d2, c2 = _carry(r, NLIMBS)                    # c2 < 2^11
    d3, c3 = _carry(d2 + c2[..., None] * _const("r260", r.device), NLIMBS)
    return _canon(d3, c3)


def from_int(v, shape=(), device=None):
    x = torch.as_tensor(int_to_limbs(v % ELL), dtype=torch.int32,
                        device=device)
    return x.expand(tuple(shape) + (NLIMBS,))


def mod(x):
    """Reduce a (weakly) normalized < ~2^260 limb value mod l."""
    d, c = _carry(x, NLIMBS)
    return _canon(d, c)


def add(x, y):
    """z = x + y mod l for canonical inputs."""
    d, _ = _carry(x + y, NLIMBS)                  # value < 2l < 2^254
    td, tc = _carry(d - _const("ell", d.device), NLIMBS)
    return torch.where((tc < 0)[..., None], d, td)


def sub_from_ell(x):
    """l - x for canonical x (l's own limbs when x == 0)."""
    d, _ = _carry(_const("ell", x.device) - x, NLIMBS)
    return d


def neg(x):
    """z = l - x (see sub_from_ell)."""
    return sub_from_ell(x)


def mul(x, y):
    """z = x * y mod l: schoolbook columns, exact carry to 39 digits plus a
    carry-out limb, then the FOLD_SC reduction."""
    d, c = _carry(_mul_cols(x, y), 2 * NLIMBS - 1)   # exact; c < 2^13
    return _reduce40(torch.cat([d, c[..., None]], -1))


def muladd(x, y, z):
    """x*y + z mod l (the S = h*a + r step of signing)."""
    return add(mul(x, y), z)


def from_bytes(b):
    """32 little-endian bytes -> canonical scalar mod l."""
    return mod(fe.from_bytes(b))


def from_bytes_raw(b):
    """32 bytes -> limbs without reduction."""
    return fe.from_bytes(b)


def to_bytes(x):
    """Canonical scalar -> 32 little-endian bytes."""
    return fe.norm_to_bytes(x)


@functools.lru_cache(maxsize=None)
def _ell_bytes(device):
    """l as 32 little-endian bytes, and the byte positions 1..32."""
    return (torch.tensor(list(ELL.to_bytes(32, "little")), dtype=torch.uint8,
                         device=device),
            torch.arange(1, 33, dtype=torch.int32, device=device))


def below_l(b):
    """[..., 32] uint8 little-endian values -> [...] bool: value < l (RFC
    8032's check of S), read at the most significant byte in which the
    value differs from l; a value equal to l differs nowhere and reads
    byte 0, where it is not below."""
    ell, pos = _ell_bytes(b.device)
    top = ((b != ell) * pos).argmax(-1, keepdim=True)
    return (b < ell).gather(-1, top).squeeze(-1)


@profiling.spanned("sc.from_digest")
def from_digest(md):
    """512-bit digest ([..., 64] uint8, little-endian) -> canonical scalar
    mod l."""
    dev = md.device
    b = md.to(torch.int32)
    b = torch.cat([b, b.new_zeros(b.shape[:-1] + (2,))], -1)  # [..., 66]
    j = _const("fd_j", dev)
    w = b[..., j] | (b[..., j + 1] << 8) | (b[..., j + 2] << 16)
    return _reduce40((w >> _const("fd_s", dev)) & MASK)


# ---------------------------------------------------------------------------
# Selftest-level API: inversion, Montgomery form and a runtime exponent
# (reference eco_InvModBPO, eco_MontMul, eco_ToMont, eco_FromMont and
# eco_ExpModBPO). Plain torch on mul, on every device.
# ---------------------------------------------------------------------------
def _square_and_multiply(t, x, bits):
    """For each bit b of `bits` (most significant first): t = t^2, then
    t = t*x where b is set. Both products are computed for every bit and
    the result selected, so the work does not depend on the exponent."""
    for bit in bits:
        t = mul(t, t)
        t = torch.where((bit == 1)[..., None], mul(t, x), t)
    return t


def inv(x):
    """1/x mod l as x^(l-2); 0 maps to 0."""
    e = ELL - 2
    bits = torch.tensor([(e >> i) & 1 for i in range(251, -1, -1)],
                        dtype=torch.int32, device=x.device)
    # t = x stands for the top bit (252) of l - 2
    return _square_and_multiply(x, x, bits.unbind(0))


# Montgomery form with R = 2^256. The reduction above already reduces a
# double-width product in one step, so x*y/R is a multiply by R^-1 mod l.
_R_MONT = pow(2, 256, ELL)
_RINV_MONT = pow(_R_MONT, ELL - 2, ELL)


def mont_mul(x, y):
    """x*y/R mod l."""
    return mul(mul(x, y), from_int(_RINV_MONT, device=x.device))


def to_mont(x):
    """x*R mod l."""
    return mul(x, from_int(_R_MONT, device=x.device))


def from_mont(x):
    """x/R mod l."""
    return mul(x, from_int(_RINV_MONT, device=x.device))


def exp_mod_bpo(x, e_bytes):
    """x^E mod l for a per-lane exponent E of [..., n] little-endian bytes,
    taken most significant first over all 8n bits."""
    e = as_bytes(e_bytes, "e_bytes", None, x.device)
    bits = (e.flip(-1).to(torch.int32)[..., None]
            >> torch.arange(7, -1, -1, dtype=torch.int32, device=x.device)) & 1
    bits = bits.reshape(bits.shape[:-2] + (-1,))           # [..., 8n]
    return _square_and_multiply(from_int(1, x.shape[:-1], x.device), x,
                                bits.unbind(-1))
