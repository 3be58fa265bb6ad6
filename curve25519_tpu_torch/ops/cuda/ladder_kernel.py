"""Wrapper of the CUDA X25519 ladder kernel (csrc/ladder.cu), the counterpart
of curve25519_tpu/ops/pallas/ladder_kernel.py.

``point_multiply_cuda`` takes the same arguments as
``models.montgomery.point_multiply`` and returns the same bytes. Tensors on a
CUDA device launch the kernel (or raise); tensors on the CPU run the plain
version, ``montgomery.point_multiply``. ``launches`` counts kernel launches.
"""

import torch

from curve25519_tpu_torch.config import NLIMBS
from curve25519_tpu_torch.models import montgomery
from curve25519_tpu_torch.ops import codec
from curve25519_tpu_torch.ops.cuda import build, flatten_batch, use_cuda

__all__ = ["point_multiply_cuda", "launches"]

launches = 0


def _bytes_arg(x, name, device=None):
    """x as a [..., 32] uint8 tensor; a tensor must already lie on `device`
    (when given), anything else is converted onto it."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.uint8, device=device)
    elif device is not None and x.device != device:
        raise ValueError("%s is on %s, the key on %s" % (name, x.device, device))
    if x.dtype != torch.uint8 or x.ndim < 1 or x.shape[-1] != 32:
        raise ValueError("%s must be [..., 32] uint8, got %s %s"
                         % (name, tuple(x.shape), x.dtype))
    return x


def point_multiply_cuda(point_bytes, sk_bytes, zr=None):
    """Batched Q = clamp(sk) * P on 32-byte encodings through the CUDA kernel.

    point_bytes and sk_bytes are [..., 32] uint8 with broadcastable batch
    axes (rank-1 inputs are one call); zr, if given, is [..., 20] int32
    signed-weak limbs broadcastable to the batch. The device of sk_bytes
    decides the route. Returns [..., 32] uint8 on that device."""
    global launches
    sk = _bytes_arg(sk_bytes, "sk_bytes")
    point = _bytes_arg(point_bytes, "point_bytes", sk.device)
    if zr is not None:
        if not isinstance(zr, torch.Tensor):
            zr = torch.as_tensor(zr, dtype=torch.int32, device=sk.device)
        if (zr.device != sk.device or zr.dtype != torch.int32 or zr.ndim < 1
                or zr.shape[-1] != NLIMBS):
            raise ValueError("zr must be [..., %d] int32 on %s, got %s %s on %s"
                             % (NLIMBS, sk.device, tuple(zr.shape), zr.dtype,
                                zr.device))
    if not use_cuda(sk):
        return montgomery.point_multiply(point, sk, zr=zr)

    lib = build.load_cuda()
    sk = codec.clamp(sk)
    batch = torch.broadcast_shapes(point.shape[:-1], sk.shape[:-1],
                                   *(() if zr is None else (zr.shape[:-1],)))
    n, unflatten = flatten_batch(batch)
    point = point.expand(batch + (32,)).reshape(n, 32).contiguous()
    sk = sk.expand(batch + (32,)).reshape(n, 32).contiguous()
    if zr is not None:
        zr = zr.expand(batch + (NLIMBS,)).reshape(n, NLIMBS).contiguous()
    out = torch.empty((n, 32), dtype=torch.uint8, device=sk.device)
    with torch.cuda.device(sk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.x25519_ladder_launch(
            out.data_ptr(), point.data_ptr(), sk.data_ptr(),
            None if zr is None else zr.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError("x25519_ladder_kernel launch failed: %s"
                           % lib.x25519_cuda_error_string(rc).decode())
    launches += 1
    return unflatten(out)
