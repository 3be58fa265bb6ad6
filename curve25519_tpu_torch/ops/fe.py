"""fe25519 — field arithmetic mod p = 2^255 - 19 on int32 limb tensors.

PyTorch counterpart of curve25519_tpu/ops/fe.py, op for op: ``[..., NLIMBS]``
int32 tensors of radix 2^13, every leading axis a batch axis, no
data-dependent control flow. Limbs between ops keep the same

    SIGNED-WEAK INVARIANT:  -1217 <= limb[i] <= WEAK_MAX = 9500,

so every 20x20 schoolbook column stays below 2^31 and every carry step (a
mask and an arithmetic shift, floor-exact for signed int32) preserves the
value. The bound analysis is in the JAX module's docstring and is proved by
tests/test_bounds.py; this module performs the same operations in the same
order and returns the same limbs bit for bit (tests/test_torch_fe.py).

These functions are also the plain version of the field core that the CUDA
header ops/cuda/csrc/fe25519.cuh holds per lane.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from curve25519_tpu_torch.config import (
    BITS, FOLD, MASK, NLIMBS, P, SQRT_M1, int_to_limbs,
)

__all__ = [
    "zero", "one", "from_int", "add", "sub", "neg", "mul", "sqr",
    "mul_small_add", "canon", "inv", "pow2523", "is_zero", "eq",
    "select", "to_bytes", "norm_to_bytes", "from_bytes", "sqrt_ratio",
    "WEAK_MAX", "WEAK_MIN",
]

WEAK_MAX = 9500
WEAK_MIN = -1217

# Static constant limb vectors (same values as the JAX module) -------------
_P_LIMBS = int_to_limbs(P)

# Subtraction pad: 32p with a borrow-raise (+2*2^13 at digit i, -2 at digit
# i+1) so all digits except the top are >= 2^14 > WEAK_MAX.
_SUB_PAD = np.full(NLIMBS, (1 << 13) - 1 + 16384 - 2, dtype=np.int32)
_SUB_PAD[0] = (1 << 13) - 1 - 607 + 16384
_SUB_PAD[19] = (1 << 13) - 1 - 2
assert sum(int(v) << (BITS * i) for i, v in enumerate(_SUB_PAD)) == 32 * P

# canon's sign-lift pad: the plain base-2^13 digits of 8p (min digit 2047).
_CANON_PAD = int_to_limbs(8 * P)
assert min(int(v) for v in _CANON_PAD) >= 2047

# Byte codec indices: limb i is bits [13i, 13i+13), inside the three bytes
# starting at 13i // 8; byte j straddles limbs 8j // 13 and 8j // 13 + 1.
_FB_J = np.array([(13 * i) // 8 for i in range(NLIMBS)])
_FB_S = np.array([(13 * i) % 8 for i in range(NLIMBS)], np.int32)
_TB_I = np.array([(8 * j) // 13 for j in range(32)])
_TB_S = np.array([8 * j - 13 * ((8 * j) // 13) for j in range(32)], np.int32)

_TABLES = {"sub_pad": _SUB_PAD, "canon_pad": _CANON_PAD, "p": _P_LIMBS,
           "fb_j": _FB_J, "fb_s": _FB_S, "tb_i": _TB_I, "tb_s": _TB_S}


@functools.lru_cache(maxsize=None)
def _table(name, device):
    """One of the static tables above as a tensor on `device` (int32 for
    limb and shift tables, int64 for gather indices)."""
    v = _TABLES[name]
    dtype = torch.int64 if v.dtype == np.int64 else torch.int32
    return torch.as_tensor(v, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Carry propagation
# ---------------------------------------------------------------------------
def _pcarry_widen(x):
    """One parallel carry step over the last axis, widening by one limb."""
    lo = x & MASK
    c = x >> BITS
    z = x.new_zeros(x.shape[:-1] + (1,))
    return torch.cat([lo, z], -1) + torch.cat([z, c], -1)


def _pcarry_wrap(x):
    """One parallel carry step on 20 limbs with the 2^260 -> 608 wrap fold."""
    lo = x & MASK
    c = x >> BITS
    return lo + torch.cat([c[..., -1:] * FOLD, c[..., :-1]], -1)


def _reduce20(cols):
    """Two wrap carry steps: any |column| <= 2^27 -> signed-weak limbs."""
    return _pcarry_wrap(_pcarry_wrap(cols))


def _reduce_product(cols):
    """Reduce 39 schoolbook columns (each < 2^30.75) to weak-all form."""
    d = _pcarry_widen(cols)                        # [..., 40]
    r = d[..., :NLIMBS] + FOLD * d[..., NLIMBS:]
    return _reduce20(r)


def _carry_seq(x, ncols):
    """Exact sequential signed carry (canonicalization only).
    Returns (digits in [0, 2^13), carry_out)."""
    c = x.new_zeros(x.shape[:-1])
    outs = []
    for i in range(ncols):
        t = x[..., i] + c
        outs.append(t & MASK)
        c = t >> BITS
    return torch.stack(outs, -1), c


# ---------------------------------------------------------------------------
# Basic ops
# ---------------------------------------------------------------------------
def zero(shape=(), device=None):
    return torch.zeros(tuple(shape) + (NLIMBS,), dtype=torch.int32,
                       device=device)


def one(shape=(), device=None):
    return from_int(1, shape, device)


def from_int(v, shape=(), device=None):
    x = torch.as_tensor(int_to_limbs(v % P), dtype=torch.int32, device=device)
    return x.expand(tuple(shape) + (NLIMBS,))


def add(x, y):
    """z = x + y (mod p). One wrap round."""
    return _pcarry_wrap(x + y)


def sub(x, y):
    """z = x - y (mod p) via the 32p pad. One wrap round."""
    return _pcarry_wrap(x - y + _table("sub_pad", x.device))


def neg(y):
    return _pcarry_wrap(_table("sub_pad", y.device) - y)


def _mul_cols(x, y):
    """Schoolbook product columns: cols[k] = sum_{i+j=k} x_i * y_j.

    One outer product [..., 20, 20], sheared so that row i moves i places to
    the right (pad each row to 40, flatten, cut to 20 rows of 39), then summed
    over rows. Integer sums below 2^31 are exact in any order, so the columns
    equal the JAX module's unrolled column sums."""
    n = NLIMBS
    x, y = torch.broadcast_tensors(x, y)
    prod = x.unsqueeze(-1) * y.unsqueeze(-2)       # prod[..., i, j] = x_i y_j
    sheared = F.pad(prod, (0, n)).flatten(-2)[..., :n * (2 * n - 1)]
    return sheared.unflatten(-1, (n, 2 * n - 1)).sum(-2, dtype=torch.int32)


def mul(x, y):
    """z = x * y (mod p)."""
    return _reduce_product(_mul_cols(x, y))


def sqr(x):
    """z = x^2 (mod p)."""
    return _reduce_product(_mul_cols(x, x))


def mul_small_add(x, c, y):
    """z = x + c * y (mod p) for a small static constant c (c <= ~2^17)."""
    d = _pcarry_widen(x + c * y)                   # [..., 21]
    r = torch.cat([d[..., :1] + FOLD * d[..., NLIMBS:],
                   d[..., 1:NLIMBS]], -1)
    return _reduce20(r)


def select(mask, a, b):
    """Branchless select: a where mask else b. mask shape = batch shape."""
    return torch.where(mask.bool()[..., None], a, b)


# ---------------------------------------------------------------------------
# Canonicalization & comparison
# ---------------------------------------------------------------------------
def canon(x):
    """Full reduction to the canonical representative in [0, p): 8p lift,
    exact carries, q = value >> 255 subtraction, one conditional subtract of
    p (the same steps as the JAX module's canon)."""
    p_limbs = _table("p", x.device)
    x = x + _table("canon_pad", x.device)
    d, c = _carry_seq(x, NLIMBS)
    d = torch.cat([d[..., :1] + FOLD * c[..., None], d[..., 1:]], -1)
    d, _ = _carry_seq(d, NLIMBS)
    q = d[..., 19] >> 8
    t = d - q[..., None] * p_limbs
    td, _ = _carry_seq(t, NLIMBS)
    ud, uc = _carry_seq(td - p_limbs, NLIMBS)
    return torch.where((uc == 0)[..., None], ud, td)


def is_zero(x):
    """True where x == 0 (mod p). Batch-shaped bool tensor."""
    return (canon(x) == 0).all(-1)


def eq(x, y):
    """True where x == y (mod p)."""
    return (canon(x) == canon(y)).all(-1)


# ---------------------------------------------------------------------------
# Inversion / exponentiation (DJB addition chains)
# ---------------------------------------------------------------------------
def _sqr_times(x, n):
    for _ in range(n):
        x = sqr(x)
    return x


def _chain_2_250(x):
    """Returns (x^(2^250 - 1), x^11): the shared prefix of the p-2 and
    (p-5)/8 addition chains."""
    x2 = sqr(x)
    x9 = mul(sqr(sqr(x2)), x)
    x11 = mul(x9, x2)
    x31 = mul(sqr(x11), x9)                        # 2^5 - 1
    t = mul(_sqr_times(x31, 5), x31)               # 2^10 - 1
    x10 = t
    t = mul(_sqr_times(t, 10), t)                  # 2^20 - 1
    t = mul(_sqr_times(t, 20), t)                  # 2^40 - 1
    t = mul(_sqr_times(t, 10), x10)                # 2^50 - 1
    x50 = t
    t = mul(_sqr_times(t, 50), t)                  # 2^100 - 1
    t = mul(_sqr_times(t, 100), t)                 # 2^200 - 1
    t = mul(_sqr_times(t, 50), x50)                # 2^250 - 1
    return t, x11


def inv(x):
    """x^(p-2) = 1/x (mod p); p - 2 = (2^250 - 1) * 2^5 + 11."""
    t, x11 = _chain_2_250(x)
    return mul(_sqr_times(t, 5), x11)


def pow2523(x):
    """x^(2^252 - 3) = x^((p-5)/8)."""
    t, _ = _chain_2_250(x)
    return mul(_sqr_times(t, 2), x)


def sqrt_ratio(u, v):
    """Return (x, ok) with x = sqrt(u/v) where it exists; ok is False where
    u/v is not a square."""
    v2 = sqr(v)
    v3 = mul(v2, v)
    a = mul(u, v3)                                 # u*v^3
    b = mul(a, sqr(v2))                            # u*v^7
    x = mul(pow2523(b), a)
    good = is_zero(sub(mul(sqr(x), v), u))
    x = select(good, x, mul(x, from_int(SQRT_M1, device=x.device)))
    good2 = is_zero(sub(mul(sqr(x), v), u))
    return x, good | good2


# ---------------------------------------------------------------------------
# Byte codec (little-endian 32-byte strings)
# ---------------------------------------------------------------------------
def norm_to_bytes(d):
    """NORMALIZED limbs (digits in [0, 2^13), value < 2^256) -> [..., 32]
    uint8 little-endian encoding."""
    dev = d.device
    d = torch.cat([d, d.new_zeros(d.shape[:-1] + (1,))], -1)  # limb 20 = 0
    tb_i, tb_s = _table("tb_i", dev), _table("tb_s", dev)
    lo = d[..., tb_i] >> tb_s
    hi = d[..., tb_i + 1] << (BITS - tb_s)
    return ((lo | hi) & 0xFF).to(torch.uint8)


def to_bytes(x):
    """Canonical little-endian 32-byte encoding: [..., 32] uint8."""
    return norm_to_bytes(canon(x))


def from_bytes(b):
    """[..., 32] uint8 little-endian -> limbs (normalized, NOT reduced mod p,
    as the JAX module's from_bytes)."""
    dev = b.device
    b = b.to(torch.int32)                          # widen before any shift
    b = torch.cat([b, b.new_zeros(b.shape[:-1] + (2,))], -1)  # [..., 34]
    fb_j, fb_s = _table("fb_j", dev), _table("fb_s", dev)
    w = b[..., fb_j] | (b[..., fb_j + 1] << 8) | (b[..., fb_j + 2] << 16)
    return (w >> fb_s) & MASK
