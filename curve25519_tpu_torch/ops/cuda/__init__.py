"""Hand-written CUDA kernels of the port (counterpart of
curve25519_tpu/ops/pallas). The kernel wrappers import nothing CUDA-specific
until they launch: the sources under csrc/ are compiled by build.py at first
use.

The device rule of every entry point of the port: a tensor keeps its device
(a CPU tensor is how a caller asks for the plain versions); anything else
(bytes, lists, numpy arrays) goes to ``device=`` when the entry point is
given one, else to the CUDA card, and with no card it raises. Nothing falls
back to the CPU.
"""

import math

import numpy as np
import torch

__all__ = ["use_cuda", "flatten_batch", "pick_device", "as_bytes",
           "as_limbs"]


def use_cuda(t):
    """The routing seam: a tensor on a CUDA device goes to the hand kernels,
    a tensor on the CPU to their plain PyTorch versions. Decided by the
    tensor's device alone; there is no fallback from the kernel."""
    return t.is_cuda


def flatten_batch(batch_shape):
    """Returns (flat_n, unflatten) where flat_n = prod(batch_shape) (1 for a
    scalar call) and unflatten(x) restores the leading axes on a
    [flat_n, ...] result."""
    batch_shape = tuple(batch_shape)
    flat_n = math.prod(batch_shape)

    def unflatten(x):
        return x.reshape(batch_shape + tuple(x.shape[1:]))

    return flat_n, unflatten


def _matches(have, want):
    return have.type == want.type and (want.index is None
                                       or have.index == want.index)


def pick_device(*args, device=None):
    """The device of an entry point's call: `device` when given, else the
    device of the first tensor among args, else the CUDA card. Raises when
    that is the card and there is none. A CUDA device comes back with its
    index."""
    if device is None:
        for a in args:
            if isinstance(a, torch.Tensor):
                return a.device
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card: pass device='cpu' (or CPU tensors) to run the "
                "plain PyTorch versions")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _as_tensor(x, dtype, name, device):
    if isinstance(x, torch.Tensor):
        if device is not None and not _matches(x.device, torch.device(device)):
            raise ValueError("%s is on %s, the call on %s"
                             % (name, x.device, device))
        return x
    if device is None:
        device = pick_device()
    if isinstance(x, (bytes, bytearray)):
        x = np.frombuffer(bytes(x), np.uint8)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def as_bytes(x, name, n=None, device=None):
    """x as a [..., n] uint8 tensor (any last size when n is None) under the
    device rule above; a tensor that is not on `device` raises."""
    x = _as_tensor(x, torch.uint8, name, device)
    if x.dtype != torch.uint8 or x.ndim < 1 or (n is not None
                                                and x.shape[-1] != n):
        raise ValueError("%s must be [..., %s] uint8, got %s %s"
                         % (name, "n" if n is None else n, tuple(x.shape),
                            x.dtype))
    return x


def as_limbs(x, name, n, device):
    """x as a [..., n] int32 limb tensor on `device` (same rule)."""
    x = _as_tensor(x, torch.int32, name, device)
    if x.dtype != torch.int32 or x.ndim < 1 or x.shape[-1] != n:
        raise ValueError("%s must be [..., %d] int32 on %s, got %s %s on %s"
                         % (name, n, device, tuple(x.shape), x.dtype,
                            x.device))
    return x
