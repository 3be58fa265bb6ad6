"""Precomputed folding tables and constant-time table gathers (counterpart of
curve25519_tpu/models/tables.py).

The folding-8 table holds all subset sums of P_i = 2^(32*i) * G, i = 0..7,
in precomputed-affine form (Y+X, Y-X, 2d*T); the folding-4 table the subset
sums of 2^(64*i) * G, i = 0..3. Both are generated from first principles by
the port's pure-Python model (refmodel), as the reference selftest does.

The gathers are indexed by secret digits, so they are one-hot contractions:
a float64 one-hot matrix times the table. Every entry is below 2^14 and one
term of each sum is nonzero, so the float64 product is exact; integer
matmul does not run on CUDA, and the plain versions run on the card too.

A verify context's q_table (a PE table built at run time) is kept as int8
planes, [..., 16, 8*NLIMBS]: per entry the low 7 bits of its 80 canonical
limbs, then their high 6 bits, the JAX package's layout byte for byte.
``gather_pe`` reads it with the same one-hot product (entries <= 127).
"""

import functools

import numpy as np
import torch

from curve25519_tpu_torch import refmodel
from curve25519_tpu_torch.config import ED_2D, NLIMBS, P, int_to_limbs
from curve25519_tpu_torch.ops import fe

__all__ = ["folding8_table", "folding4_table", "gather_pa", "gather_pa4",
           "gather_pe", "pe_planes_from_array", "pe_planes_from_canonical"]


@functools.lru_cache(maxsize=None)
def _folding_table(nfolds, ndoubles):
    """[2^nfolds, 3, NLIMBS] int32: all subset sums of
    P_i = 2^(ndoubles*i) * G, i = 0..nfolds-1, in (YpX, YmX, T2d) form."""
    points = []
    g = refmodel.BASE
    for _ in range(nfolds):
        points.append(g)
        for _ in range(ndoubles):
            g = refmodel.ed_double(g)
    nent = 1 << nfolds
    out = np.zeros((nent, 3, NLIMBS), dtype=np.int32)
    for idx in range(nent):
        acc = refmodel.IDENTITY
        for i in range(nfolds):
            if (idx >> i) & 1:
                acc = refmodel.ed_add(acc, points[i])
        x, y = acc
        out[idx, 0] = int_to_limbs((y + x) % P)
        out[idx, 1] = int_to_limbs((y - x) % P)
        out[idx, 2] = int_to_limbs(ED_2D * x * y % P)
    out.setflags(write=False)
    return out


def folding8_table():
    """[256, 3, NLIMBS] int32 folding-8 table; entry 0 is the identity
    (1, 1, 0)."""
    return _folding_table(8, 32)


def folding4_table():
    """[16, 3, NLIMBS] int32 folding-4 table (subset sums of 2^(64*i) * G,
    i = 0..3)."""
    return _folding_table(4, 64)


@functools.lru_cache(maxsize=None)
def _table_f64(nfolds, device):
    t = folding8_table() if nfolds == 8 else folding4_table()
    return torch.tensor(t.reshape(len(t), 3 * NLIMBS), dtype=torch.float64,
                        device=device)


def _gather(idx, nfolds):
    table = _table_f64(nfolds, idx.device)
    iota = torch.arange(table.shape[0], dtype=idx.dtype, device=idx.device)
    onehot = (idx[..., None] == iota).to(torch.float64)
    vals = (onehot @ table).to(torch.int32).unflatten(-1, (3, NLIMBS))
    return {"ypx": vals[..., 0, :], "ymx": vals[..., 1, :],
            "t2d": vals[..., 2, :]}


def gather_pa(cut):
    """cut: [...] int32 index in [0, 256) -> PA point dict of [..., NLIMBS]
    limb tensors from the folding-8 table (constant-time)."""
    return _gather(cut, 8)


def gather_pa4(cut):
    """cut: [...] int32 index in [0, 16) -> PA point dict from the
    folding-4 table (constant-time)."""
    return _gather(cut, 4)


def pe_planes_from_canonical(pe_array):
    """[..., N, 4, NLIMBS] CANONICAL limbs (digits in [0, 2^13)) -> int8
    planes [..., N, 8*NLIMBS]: the low 7 bits of the N entries' 80 limbs,
    then their high 6 bits, per entry."""
    flat = pe_array.flatten(-2)
    return torch.cat([(flat & 0x7F).to(torch.int8),
                      (flat >> 7).to(torch.int8)], -1)


def pe_planes_from_array(pe_array):
    """Int8 planes of a PE table [..., N, 4, NLIMBS] of signed-weak limbs,
    canonicalized first (the 7-bit split is exact on [0, 2^14) only)."""
    return pe_planes_from_canonical(fe.canon(pe_array))


def gather_pe(idx, planes, nent=16):
    """idx: [...] int32 in [0, nent); planes: [..., nent, 8*NLIMBS], int8 or
    already float64 (a caller that gathers many times converts once), with
    leading axes that broadcast against idx's (one q_table per lane, or one
    for all). Returns a PE point dict of [..., NLIMBS] int32 limbs; a batched
    one-hot product, exact as _gather's."""
    iota = torch.arange(nent, dtype=idx.dtype, device=idx.device)
    onehot = (idx[..., None] == iota).to(torch.float64)
    flat = (onehot.unsqueeze(-2) @ planes.to(torch.float64)).squeeze(-2)
    flat = flat.to(torch.int32)
    w = 4 * NLIMBS
    vals = (flat[..., :w] + (flat[..., w:] << 7)).unflatten(-1, (4, NLIMBS))
    return {"ypx": vals[..., 0, :], "ymx": vals[..., 1, :],
            "t2d": vals[..., 2, :], "z2": vals[..., 3, :]}
