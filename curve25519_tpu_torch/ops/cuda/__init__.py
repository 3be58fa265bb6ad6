"""Hand-written CUDA kernels of the port (counterpart of
curve25519_tpu/ops/pallas). The kernel wrappers import nothing CUDA-specific
until they launch: the sources under csrc/ are compiled by build.py at first
use."""

import math

__all__ = ["use_cuda", "flatten_batch"]


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
