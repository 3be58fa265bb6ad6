"""FOLDING digit extraction (counterpart of curve25519_tpu/ops/fold.py).

A fold is a bit permutation of the 256-bit scalar. ``cut8``/``cut4`` take
an explicit [..., 256] bit tensor; the ``*_bytes`` and ``*_limbs`` forms
read the digits straight from the scalar's byte or limb encoding through
static gather indices, one shift, one mask and a power-of-two sum.

Bit conventions (those of the JAX module):
- 8-fold: cut[c] (c = 0..31) has bit j = scalar bit 32*j + (31 - c); cut[0]
  holds the most-significant slice.
- 4-fold: v[c] (c = 0..31) takes bits from odd 32-bit words 1,3,5,7 at
  position 31-c (bit m of v[c] = scalar bit 32*(2m+1) + 31 - c); v[32 + c]
  from even words 0,2,4,6.
"""

import functools

import numpy as np
import torch

from curve25519_tpu_torch.config import BITS
from curve25519_tpu_torch.utils import profiling

__all__ = ["cut8", "cut4", "cut8_bytes", "cut4_bytes",
           "cut8_limbs", "cut4_limbs"]


def _weights(nbits, device):
    return torch.tensor([1 << j for j in range(nbits)], dtype=torch.int32,
                        device=device)


def cut8(bits):
    """bits: [..., 256] -> [..., 32] int32 digits in [0, 256)."""
    b = bits.to(torch.int32).unflatten(-1, (8, 32)).flip(-1)  # [.., j, c]
    return (b * _weights(8, b.device)[:, None]).sum(-2, dtype=torch.int32)


def cut4(bits):
    """bits: [..., 256] -> [..., 64] int32 digits in [0, 16): the first 32
    from odd words, the last 32 from even words."""
    b = bits.to(torch.int32).unflatten(-1, (8, 32)).flip(-1)
    w = _weights(4, b.device)[:, None]
    odd = (b[..., 1::2, :] * w).sum(-2, dtype=torch.int32)
    even = (b[..., 0::2, :] * w).sum(-2, dtype=torch.int32)
    return torch.cat([odd, even], -1)


def _bit_positions(nfolds):
    if nfolds == 8:       # [32, 8]: digit c, weight-bit j <- bit 32j + 31 - c
        return np.array([[32 * j + 31 - c for j in range(8)]
                         for c in range(32)])
    odd = [[32 * (2 * m + 1) + 31 - c for m in range(4)] for c in range(32)]
    even = [[32 * (2 * m) + 31 - c for m in range(4)] for c in range(32)]
    return np.array(odd + even)                       # [64, 4]


@functools.lru_cache(maxsize=None)
def _index(nfolds, radix_bits, device):
    """(word index, shift) tables [ndigits, nbits] for words of radix_bits
    bits (8 for bytes, 13 for limbs), as tensors on `device`."""
    pos = _bit_positions(nfolds)
    return (torch.as_tensor(pos // radix_bits, device=device),
            torch.as_tensor((pos % radix_bits).astype(np.int32),
                            device=device))


def _cut_gather(x, nfolds, radix_bits):
    idx, sh = _index(nfolds, radix_bits, x.device)
    g = (x.to(torch.int32)[..., idx] >> sh) & 1       # [..., ndigits, nbits]
    return (g * _weights(idx.shape[1], x.device)).sum(-1, dtype=torch.int32)


@profiling.spanned("fold.cut8_bytes")
def cut8_bytes(b):
    """[..., 32] uint8 LE scalar bytes -> [..., 32] 8-fold digits."""
    return _cut_gather(b, 8, 8)


def cut4_bytes(b):
    """[..., 32] uint8 LE scalar bytes -> [..., 64] 4-fold digits."""
    return _cut_gather(b, 4, 8)


def cut8_limbs(x):
    """[..., NLIMBS] NORMALIZED limbs (every digit in [0, 2^13)) ->
    [..., 32] 8-fold digits; equals cut8_bytes of the value's encoding."""
    return _cut_gather(x, 8, BITS)


@profiling.spanned("fold.cut4_limbs")
def cut4_limbs(x):
    """[..., NLIMBS] normalized limbs -> [..., 64] 4-fold digits."""
    return _cut_gather(x, 4, BITS)
