"""Wrapper of the CUDA folding base-multiply kernel (csrc/basemult.cu), the
counterpart of curve25519_tpu/ops/pallas/edwards_kernel.py, and its plain
version.

``base_mult(cut, zr, bp, mode, nfolds)`` takes the fold digits of a scalar
([..., 32] for nfolds=8, [..., 64] for nfolds=4; ops/fold.py), an optional
projective randomizer zr ([..., 20] int32), an optional PE blinding point
bp (dict of [..., 20] int32: ypx, ymx, t2d, z2) and returns, by mode:
"affine" (x, y) limbs, "mont_u" (u, u) limbs with u = (Z+Y)/(Z-Y), "pk" the
compressed point bytes, "u_bytes" enc(u). CUDA tensors launch the kernel
(or raise); CPU tensors run ``base_mult_plain``. ``launches`` counts kernel
launches.
"""

import functools

import numpy as np
import torch

from curve25519_tpu_torch.config import NLIMBS, limbs_to_int
from curve25519_tpu_torch.models import edwards, tables
from curve25519_tpu_torch.ops import fe
from curve25519_tpu_torch.ops.cuda import (
    as_limbs, build, flatten_batch, use_cuda,
)
from curve25519_tpu_torch.utils import profiling

__all__ = ["base_mult", "base_mult_plain", "packed_table", "word_table",
           "mma_word_table", "kernel_table", "launches", "MODES"]

MODES = {"affine": 0, "mont_u": 1, "pk": 2, "u_bytes": 3}
PE_KEYS = ("ypx", "ymx", "t2d", "z2")

launches = 0


@functools.lru_cache(maxsize=None)
@profiling.spanned("edwards_kernel.packed_table")
def packed_table(nfolds, device):
    """The folding table in the 13-bit lane's layout (fold 4's limb modes
    read nfolds=4), on `device`: per entry 32 int32 words, word k =
    limb 2k | limb 2k+1 << 16 of the 60 limbs ypx ++ ymx ++ t2d, words 30
    and 31 zero."""
    t = tables.folding8_table() if nfolds == 8 else tables.folding4_table()
    t = t.reshape(len(t), 3 * NLIMBS)
    packed = np.zeros((len(t), 32), np.int32)
    packed[:, :3 * NLIMBS // 2] = t[:, 0::2] | (t[:, 1::2] << 16)
    return torch.as_tensor(packed.reshape(-1), device=device)


@functools.lru_cache(maxsize=None)
@profiling.spanned("edwards_kernel.word_table")
def word_table(nfolds, device):
    """The folding table as the wide lanes read it (fold 4's byte modes,
    nfolds=4; verify's double-scalar multiply and, in the tensor-core
    layout of mma_word_table, the fold-8 gathers, nfolds=8), on `device`: per
    entry 24 int32 words, each of ypx, ymx and t2d as the 8 little-endian
    32-bit words of its canonical value (the tables hold canonical limbs)."""
    t = tables.folding8_table() if nfolds == 8 else tables.folding4_table()
    raw = b"".join(limbs_to_int(c).to_bytes(32, "little")
                   for entry in t for c in entry)
    return torch.as_tensor(np.frombuffer(raw, "<i4").copy(), device=device)


@functools.lru_cache(maxsize=None)
@profiling.spanned("edwards_kernel.mma_word_table")
def mma_word_table(device):
    """word_table(8) as the B operand of the tensor-core gather of the sign,
    keygen and fold-8 base-multiply kernels (csrc/gather_mma.cuh), on
    `device`: the [256 entries x 96 bytes] matrix of the entries' bytes,
    its 12 n-tiles of 8 columns ordered so that each thread of a warp ends
    with whole words (column 2t + b of n-tile 2k + h is byte 2h + b of word
    4k + t of the entry), stored per (k-step of 32 entries, n-tile) as the
    32 lanes' two mma.sync B registers: lane 4g + t holds column g of
    entries 32ks + 4t + i (register 0) and 32ks + 16 + 4t + i (register 1),
    i = 0..3 from the low byte up. int32 [8 * 12 * 32 * 2]."""
    b = word_table(8, torch.device("cpu")).numpy().view(np.uint8)
    # entry byte 16k + 4t + 2h + b -> column 8 (2k + h) + 2t + b
    cols = b.reshape(256, 6, 4, 2, 2).transpose(0, 1, 3, 2, 4)
    # entry e = 32ks + 16h + 4t + i, column c = 8nt + g -> [ks, nt, g, t, h, i]
    frag = cols.reshape(8, 2, 4, 4, 12, 8).transpose(0, 4, 5, 2, 1, 3)
    return torch.as_tensor(np.ascontiguousarray(frag).view("<i4").reshape(-1),
                           device=device)


def kernel_table(nfolds, mode, device):
    """The table that the launch of (nfolds, mode) reads: the word table in
    the tensor-core layout for fold 8 (every mode), the word table for fold
    4's byte modes (the wide lane), the packed table for its limb modes (the
    13-bit lane)."""
    if nfolds == 8:
        return mma_word_table(device)
    return word_table(4, device) if mode in ("pk", "u_bytes") else \
        packed_table(4, device)


def base_mult_plain(cut, zr=None, bp=None, mode="affine", nfolds=8):
    """The plain version: models/edwards' folding multiply, the blinding
    add, and the epilogue of `mode`."""
    mult = (edwards.base_point_mult if nfolds == 8
            else edwards.base_point_mult_fold4)
    s = mult(cut, zr=zr)
    if bp is not None:
        s = edwards.add_pe(s, bp)
    if mode in ("affine", "pk"):
        x, y = edwards.to_affine(s)
        if mode == "affine":
            return x, y
        return edwards.pack(x, y)
    u = fe.mul(fe.add(s["z"], s["y"]), fe.inv(fe.sub(s["z"], s["y"])))
    return (u, u) if mode == "mont_u" else fe.to_bytes(u)


def limb_rows(x, batch, n):
    """(rows, stride) for the kernels: a [..., k] int32 tensor broadcast to
    `batch` as [n, k] contiguous rows, or one shared row (stride 0) when x
    has no batch axes; (None, 0) for None."""
    if x is None:
        return None, 0
    if x.ndim == 1:
        return x.contiguous(), 0
    return x.expand(batch + x.shape[-1:]).reshape(n, -1).contiguous(), \
        x.shape[-1]


def pe_rows(bp, batch, n, device):
    """A PE point dict as kernel rows of 80 limbs (ypx, ymx, t2d, z2)."""
    if bp is None:
        return None, 0
    coords = [as_limbs(bp[k], "bp[%s]" % k, NLIMBS, device) for k in PE_KEYS]
    return limb_rows(torch.cat(torch.broadcast_tensors(*coords), -1), batch,
                     n)


def base_mult(cut, zr=None, bp=None, mode="affine", nfolds=8):
    """Batched folding base multiply (see the module docstring). The device
    of `cut` decides the route; zr and bp must lie on it."""
    global launches
    if mode not in MODES or nfolds not in (4, 8):
        raise ValueError("bad mode %r or nfolds %r" % (mode, nfolds))
    ncuts = 256 // nfolds
    if cut.dtype != torch.int32 or cut.ndim < 1 or cut.shape[-1] != ncuts:
        raise ValueError("cut must be [..., %d] int32, got %s %s"
                         % (ncuts, tuple(cut.shape), cut.dtype))
    if zr is not None:
        zr = as_limbs(zr, "zr", NLIMBS, cut.device)
    if not use_cuda(cut):
        if bp is not None:
            bp = {k: as_limbs(bp[k], "bp[%s]" % k, NLIMBS, cut.device)
                  for k in PE_KEYS}
        return base_mult_plain(cut, zr=zr, bp=bp, mode=mode, nfolds=nfolds)

    batch = cut.shape[:-1]
    n, unflatten = flatten_batch(batch)
    cut = cut.reshape(n, ncuts).contiguous()
    zr_rows, zr_stride = limb_rows(zr, batch, n)
    bp_rows, bp_stride = pe_rows(bp, batch, n, cut.device)
    byte_mode = mode in ("pk", "u_bytes")
    out = torch.empty((n, 32) if byte_mode else (n, 2 * NLIMBS),
                      dtype=torch.uint8 if byte_mode else torch.int32,
                      device=cut.device)
    table = kernel_table(nfolds, mode, cut.device)
    build.launch("basemult", "basemult_launch", cut.device, out.data_ptr(),
                 cut.data_ptr(),
                 None if zr_rows is None else zr_rows.data_ptr(), zr_stride,
                 None if bp_rows is None else bp_rows.data_ptr(), bp_stride,
                 table.data_ptr(), nfolds, MODES[mode], n, n=n)
    launches += 1
    if byte_mode:
        return unflatten(out)
    return unflatten(out[:, :NLIMBS]), unflatten(out[:, NLIMBS:])
