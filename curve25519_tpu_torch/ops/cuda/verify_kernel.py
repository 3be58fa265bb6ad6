"""Wrappers of the CUDA Ed25519 verification kernels (csrc/verify.cu,
csrc/poly.cu, csrc/oneshot.cu, csrc/digits.cu), the counterpart of
curve25519_tpu/ops/pallas/verify_kernel.py, and their plain versions.

- ``verify_init(pk)``: [..., 32] uint8 public keys -> (planes [..., 16, 160]
  int8, ok [...] bool): the q_table of -Q as a verify context holds it
  (models/tables.pe_planes_from_canonical), and whether the key decoded.
- ``poly_mult(u, v, planes)``: enc(s*G + h*(-Q)) [..., 32] uint8 from the
  8-fold digits u [..., 32] of s and the 4-fold digits v [..., 64] of h
  (ops/fold), against one q_table per lane (planes [..., 16, 160]) or, when
  planes.ndim == 2, one q_table for every lane (the shared kernel).
- ``verify_oneshot(pk, u, v)``: (enc(R') [..., 32] uint8, ok [...] bool),
  the two in one launch (csrc/oneshot.cu): persistent blocks, one per SM,
  each running the same rounds over its share of the lanes (whole warps of
  consecutive lanes, spread evenly over the blocks and their rounds), with
  a scratch row for the q_table of each of its threads that the launch
  alone uses. The library sizes the scratch (``oneshot_scratch_rows``) and
  takes its grid from it.
- ``digits(md, s)``: (u [..., 32], v [..., 64]) int32, the digits that
  poly_mult and verify_oneshot read: the 8-fold digits of S's raw bytes s
  [..., 32] (not reduced) and the 4-fold digits of h = md mod l from
  SHA-512 digests md [..., 64] uint8, in one launch (csrc/digits.cu).
  ed25519.verify and verify_check launch it once a call on a card.

The multiply reads the folding-8 table as ``edwards_kernel.word_table(8)``.

The first three have a ``*_plain`` version on models/edwards and
models/tables; CUDA tensors launch the kernels (or raise), CPU tensors run
the plain versions. ``digits`` takes CUDA tensors only: its plain version
is fold.cut8_bytes(s) and fold.cut4_limbs(sc.from_digest(md)), which
models/ed25519 calls for CPU tensors. ``launches`` counts kernel launches
per kernel. ``oneshot_warps`` sums over one-shot launches the warps of the
busiest block (``busiest``, from the library's split) and the mean warps a
block (``mean``): mean / busiest is the share of the SMs' warp slots the
launch fills.
"""

import torch

from curve25519_tpu_torch.config import NLIMBS
from curve25519_tpu_torch.models import edwards, tables
from curve25519_tpu_torch.ops import fe
from curve25519_tpu_torch.ops.cuda import (
    build, edwards_kernel, flatten_batch, use_cuda,
)
from curve25519_tpu_torch.utils import profiling

__all__ = ["verify_init", "verify_init_plain", "poly_mult", "poly_mult_plain",
           "verify_oneshot", "verify_oneshot_plain", "digits", "launches"]

QT_SHAPE = (16, 8 * NLIMBS)
ONESHOT_BLOCK = 512                    # csrc/oneshot.cu's kOneshotBlock

launches = {"verify_init": 0, "poly": 0, "poly_shared": 0, "oneshot": 0,
            "digits": 0}
oneshot_warps = {"busiest": 0, "mean": 0.0}


def verify_init_plain(pk):
    """The plain version of the Verify_Init kernel: decompress -Q, then the
    16 subset sums of {-Q, 2^64(-Q), 2^128(-Q), 2^192(-Q)} in PE form from
    192 doublings (reference ed25519_Verify_Init)."""
    q, ok = edwards.unpack_point(pk, negate=True)
    batch, dev = pk.shape[:-1], pk.device
    qt = [None] * 16
    qt[0] = {"ypx": fe.one(batch, dev), "ymx": fe.one(batch, dev),
             "t2d": fe.zero(batch, dev), "z2": fe.from_int(2, batch, dev)}
    qt[1] = edwards.to_pe(q)
    for base in (2, 4, 8):
        for _ in range(64):
            q = edwards.double(q)
        qt[base] = edwards.to_pe(q)
        for s in range(1, base):
            qt[base + s] = edwards.to_pe(edwards.add_pe(q, qt[s]))
    arr = torch.stack([torch.stack([e[k] for k in edwards_kernel.PE_KEYS], -2)
                       for e in qt], -3)               # [..., 16, 4, NLIMBS]
    return tables.pe_planes_from_array(arr), ok


def poly_mult_plain(u, v, planes):
    """The plain version of the poly kernels (either q_table route)."""
    return edwards.pack(*edwards.poly_point_mult(u, v, planes))


def verify_oneshot_plain(pk, u, v):
    """The plain version of the one-shot kernel: the two plain phases."""
    planes, ok = verify_init_plain(pk)
    return poly_mult_plain(u, v, planes), ok


def _check(t, name, dtype, tail):
    if t.dtype != dtype or t.ndim < len(tail) or tuple(t.shape[t.ndim - len(
            tail):]) != tail:
        raise ValueError("%s must be [..., %s] %s, got %s %s"
                         % (name, ", ".join(map(str, tail)), dtype,
                            tuple(t.shape), t.dtype))


def _same_device(*ts):
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("inputs on several devices: %s"
                         % sorted({str(t.device) for t in ts}))


def _rows(t, batch, n, tail):
    """t broadcast to batch + tail as [n, *tail] contiguous rows."""
    return t.expand(batch + tail).reshape((n,) + tail).contiguous()


def _aligned(t):
    """t itself, or a copy when its data does not start on 16 bytes (the
    kernels read q_table entries with 16-byte loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def verify_init(pk):
    """(planes [..., 16, 160] int8, ok [...] bool) of public keys pk
    [..., 32] uint8: the CUDA kernel for a CUDA pk, the plain version for a
    CPU one."""
    _check(pk, "pk", torch.uint8, (32,))
    if not use_cuda(pk):
        return verify_init_plain(pk)
    batch = pk.shape[:-1]
    n, unflatten = flatten_batch(batch)
    pk = pk.reshape(n, 32).contiguous()
    planes = torch.empty((n,) + QT_SHAPE, dtype=torch.int8, device=pk.device)
    ok = torch.empty((n,), dtype=torch.bool, device=pk.device)
    build.launch("verify", "verify_init_launch", pk.device, planes.data_ptr(),
                 ok.data_ptr(), pk.data_ptr(), n, n=n)
    launches["verify_init"] += 1
    return unflatten(planes), unflatten(ok)


def poly_mult(u, v, planes):
    """enc(s*G + h*(-Q)) [..., 32] uint8 (see the module docstring). Batch
    axes of u, v and per-lane planes broadcast."""
    _check(u, "u", torch.int32, (32,))
    _check(v, "v", torch.int32, (64,))
    _check(planes, "planes", torch.int8, QT_SHAPE)
    _same_device(u, v, planes)
    if not use_cuda(u):
        return poly_mult_plain(u, v, planes)
    shared = planes.ndim == 2
    batch = torch.broadcast_shapes(u.shape[:-1], v.shape[:-1],
                                   () if shared else planes.shape[:-2])
    n, unflatten = flatten_batch(batch)
    with profiling.span("verify_kernel.poly_rows", n):
        u, v = _rows(u, batch, n, (32,)), _rows(v, batch, n, (64,))
        planes = _aligned(planes.contiguous() if shared
                          else _rows(planes, batch, n, QT_SHAPE))
        out = torch.empty((n, 32), dtype=torch.uint8, device=u.device)
    build.launch("poly", "poly_launch", u.device, out.data_ptr(),
                 u.data_ptr(), v.data_ptr(), planes.data_ptr(), int(shared),
                 edwards_kernel.word_table(8, u.device).data_ptr(), n, n=n)
    launches["poly_shared" if shared else "poly"] += 1
    return unflatten(out)


def oneshot_scratch_rows(n, device):
    """Scratch rows of the one-shot launch for n lanes on `device`, as the
    library decides them (a row per thread of its grid)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return build.load_cuda("oneshot").oneshot_scratch_rows(n, sms)


def verify_oneshot(pk, u, v):
    """(enc(R') [..., 32] uint8, ok [...] bool) in one launch for CUDA
    tensors, verify_oneshot_plain for CPU ones. Batch axes broadcast."""
    _check(pk, "pk", torch.uint8, (32,))
    _check(u, "u", torch.int32, (32,))
    _check(v, "v", torch.int32, (64,))
    _same_device(pk, u, v)
    if not use_cuda(pk):
        return verify_oneshot_plain(pk, u, v)
    batch = torch.broadcast_shapes(pk.shape[:-1], u.shape[:-1], v.shape[:-1])
    n, unflatten = flatten_batch(batch)
    with profiling.span("verify_kernel.oneshot_rows", n):
        pk = _rows(pk, batch, n, (32,))
        u, v = _rows(u, batch, n, (32,)), _rows(v, batch, n, (64,))
        out = torch.empty((n, 32), dtype=torch.uint8, device=pk.device)
        ok = torch.empty((n,), dtype=torch.bool, device=pk.device)
        rows = oneshot_scratch_rows(n, pk.device)
        scratch = torch.empty((rows,) + QT_SHAPE, dtype=torch.int8,
                              device=pk.device)
    build.launch("oneshot", "oneshot_launch", pk.device, out.data_ptr(),
                 ok.data_ptr(), scratch.data_ptr(), rows, pk.data_ptr(),
                 u.data_ptr(), v.data_ptr(),
                 edwards_kernel.word_table(8, pk.device).data_ptr(), n, n=n)
    launches["oneshot"] += 1
    if rows:
        grid = rows // ONESHOT_BLOCK
        oneshot_warps["busiest"] += build.load_cuda(
            "oneshot").oneshot_busiest_warps(n, grid)
        oneshot_warps["mean"] += -(-n // 32) / grid
    return unflatten(out), unflatten(ok)


def digits(md, s):
    """(u [..., 32], v [..., 64]) int32 fold digits of S's bytes s [..., 32]
    and of h = md mod l from digests md [..., 64] uint8, by one launch of
    digits_kernel (see the module docstring): s broadcasts to md's batch,
    and its rows are read in place at their stride. Both on one card, each
    row's bytes contiguous; anything else raises."""
    _check(md, "md", torch.uint8, (64,))
    _check(s, "s", torch.uint8, (32,))
    _same_device(md, s)
    if not md.is_cuda:
        raise ValueError("digits runs on a card: md and s are on %s"
                         % md.device)
    batch = md.shape[:-1]
    n, unflatten = flatten_batch(batch)
    md, s = md.reshape(n, 64), s.expand(batch + (32,)).reshape(n, 32)
    if md.stride(1) != 1 or s.stride(1) != 1:
        raise ValueError("digits reads each row's bytes in order: md and s "
                         "have byte strides %d and %d"
                         % (md.stride(1), s.stride(1)))
    u = torch.empty((n, 32), dtype=torch.int32, device=md.device)
    v = torch.empty((n, 64), dtype=torch.int32, device=md.device)
    build.launch("digits", "digits_launch", md.device, u.data_ptr(),
                 v.data_ptr(), md.data_ptr(), md.stride(0), s.data_ptr(),
                 s.stride(0), n, n=n)
    launches["digits"] += 1
    return unflatten(u), unflatten(v)
