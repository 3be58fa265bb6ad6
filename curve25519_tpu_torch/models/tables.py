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
"""

import functools

import numpy as np
import torch

from curve25519_tpu_torch import refmodel
from curve25519_tpu_torch.config import ED_2D, NLIMBS, P, int_to_limbs

__all__ = ["folding8_table", "folding4_table", "gather_pa", "gather_pa4"]


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
