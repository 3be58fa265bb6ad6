"""Wrapper of the CUDA X25519 ladder kernel (csrc/ladder.cu), the counterpart
of curve25519_tpu/ops/pallas/ladder_kernel.py.

``point_multiply_cuda`` takes the same arguments as
``models.montgomery.point_multiply`` and returns the same bytes. Tensors on a
CUDA device launch the kernel (or raise); tensors on the CPU run the plain
version, ``montgomery.point_multiply``. ``launches`` counts kernel launches;
``pipe_products`` sums over launches the limb products the lanes issued on
each of the card's multipliers (``"fp64"``: three of each ladder step's five
multiplies, on the FP64 pipe; ``"int"``: the rest, on IMAD.WIDE), each launch
adding its lanes times the per-lane counts that the library exports
(``x25519_ladder_products``, ``lane_products``).
"""

import ctypes
import functools

import torch

from curve25519_tpu_torch.config import NLIMBS
from curve25519_tpu_torch.models import montgomery
from curve25519_tpu_torch.ops import codec
from curve25519_tpu_torch.ops.cuda import (
    as_bytes, as_limbs, build, flatten_batch, pick_device, use_cuda,
)

__all__ = ["point_multiply_cuda", "launches", "pipe_products",
           "lane_products"]

launches = 0
pipe_products = {"fp64": 0, "int": 0}


@functools.cache
def lane_products():
    """{"fp64": n, "int": n}: the limb products one lane of the kernel
    issues on each pipe, as the CUDA library (built on first use) gives
    them."""
    counts = (ctypes.c_int64 * 2)()
    build.load_cuda("ladder").x25519_ladder_products(counts)
    return {"fp64": counts[0], "int": counts[1]}


def point_multiply_cuda(point_bytes, sk_bytes, zr=None, device=None):
    """Batched Q = clamp(sk) * P on 32-byte encodings through the CUDA kernel.

    point_bytes and sk_bytes are [..., 32] uint8 with broadcastable batch
    axes (rank-1 inputs are one call); zr, if given, is [..., 20] int32
    signed-weak limbs broadcastable to the batch. The call's device follows
    the rule of ops/cuda (`device`, else the key's, else the card's).
    Returns [..., 32] uint8 on that device."""
    global launches
    dev = pick_device(sk_bytes, point_bytes, zr, device=device)
    sk = as_bytes(sk_bytes, "sk_bytes", 32, dev)
    point = as_bytes(point_bytes, "point_bytes", 32, dev)
    if zr is not None:
        zr = as_limbs(zr, "zr", NLIMBS, dev)
    if not use_cuda(sk):
        return montgomery.point_multiply(point, sk, zr=zr)

    sk = codec.clamp(sk)
    batch = torch.broadcast_shapes(point.shape[:-1], sk.shape[:-1],
                                   *(() if zr is None else (zr.shape[:-1],)))
    n, unflatten = flatten_batch(batch)
    point = point.expand(batch + (32,)).reshape(n, 32).contiguous()
    sk = sk.expand(batch + (32,)).reshape(n, 32).contiguous()
    if zr is not None:
        zr = zr.expand(batch + (NLIMBS,)).reshape(n, NLIMBS).contiguous()
    out = torch.empty((n, 32), dtype=torch.uint8, device=sk.device)
    build.launch("ladder", "x25519_ladder_launch", sk.device, out.data_ptr(),
                 point.data_ptr(), sk.data_ptr(),
                 None if zr is None else zr.data_ptr(), n, n=n)
    launches += 1
    for pipe, count in lane_products().items():
        pipe_products[pipe] += n * count
    return unflatten(out)
