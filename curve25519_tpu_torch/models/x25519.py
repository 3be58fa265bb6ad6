"""X25519 Diffie-Hellman API on ``[..., 32]`` uint8 tensors (counterpart of
curve25519_tpu/models/x25519.py). Batch axes scale throughput: one call is
many DH operations. Secret keys are never modified; clamping is internal.

Both functions go through the routing seam in
ops/cuda/ladder_kernel.point_multiply_cuda: keys on a CUDA device run the
CUDA ladder kernel, keys on the CPU its plain version
(models/montgomery.point_multiply).
"""

import torch

from curve25519_tpu_torch.config import MONT_BASE_U
from curve25519_tpu_torch.ops.cuda import ladder_kernel

__all__ = ["calculate_public_key", "create_shared_key"]


def _base_u(shape, device):
    b = torch.zeros(tuple(shape) + (32,), dtype=torch.uint8, device=device)
    b[..., 0] = MONT_BASE_U
    return b


def calculate_public_key(sk, zr=None):
    """pk = clamp(sk) * G via the Montgomery ladder from u = 9."""
    if not isinstance(sk, torch.Tensor):
        sk = torch.as_tensor(sk, dtype=torch.uint8)
    return ladder_kernel.point_multiply_cuda(
        _base_u(sk.shape[:-1], sk.device), sk, zr=zr)


def create_shared_key(peer_pk, sk, zr=None):
    """shared = clamp(sk) * peer_pk."""
    return ladder_kernel.point_multiply_cuda(peer_pk, sk, zr=zr)
