"""X25519 Diffie-Hellman API on ``[..., 32]`` uint8 tensors (counterpart of
curve25519_tpu/models/x25519.py). Batch axes scale throughput: one call is
many DH operations. Secret keys are never modified; clamping is internal.

The device rule of ops/cuda applies: a tensor keeps its device, anything
else goes to `device=` or to the card. On a CUDA device the ladder routes
run the CUDA ladder kernel (ops/cuda/ladder_kernel.py) and
`calculate_public_key_fast` the base-multiply kernel
(ops/cuda/edwards_kernel.py); on the CPU their plain versions run.
"""

import torch

from curve25519_tpu_torch.config import MONT_BASE_U
from curve25519_tpu_torch.ops import codec, fold
from curve25519_tpu_torch.ops.cuda import (
    as_bytes, edwards_kernel, ladder_kernel, pick_device,
)
from curve25519_tpu_torch.utils import profiling

__all__ = ["calculate_public_key", "calculate_public_key_fast",
           "create_shared_key"]


def _base_u(shape, device):
    b = torch.zeros(tuple(shape) + (32,), dtype=torch.uint8, device=device)
    b[..., 0] = MONT_BASE_U
    return b


def calculate_public_key(sk, zr=None, device=None):
    """pk = clamp(sk) * G via the Montgomery ladder from u = 9."""
    sk = as_bytes(sk, "sk", 32, pick_device(sk, zr, device=device))
    return ladder_kernel.point_multiply_cuda(
        _base_u(sk.shape[:-1], sk.device), sk, zr=zr)


@profiling.spanned("x25519.calculate_public_key_fast", n=profiling.rows)
def calculate_public_key_fast(sk, zr=None, nfolds=8, device=None):
    """pk via the folding base-point multiply on the Edwards curve and the
    birational map u = (Z+Y)/(Z-Y). nfolds=8 uses the 256-entry folding
    table (32 steps), nfolds=4 the 16-entry one (64 steps). Same bytes as
    calculate_public_key."""
    if nfolds not in (4, 8):
        raise ValueError("nfolds must be 8 or 4, got %r" % (nfolds,))
    sk = codec.clamp(as_bytes(sk, "sk", 32, pick_device(sk, zr,
                                                        device=device)))
    cut = (fold.cut8_bytes if nfolds == 8 else fold.cut4_bytes)(sk)
    return edwards_kernel.base_mult(cut, zr=zr, mode="u_bytes",
                                    nfolds=nfolds)


@profiling.spanned("x25519.create_shared_key", n=profiling.rows)
def create_shared_key(peer_pk, sk, zr=None, device=None):
    """shared = clamp(sk) * peer_pk."""
    return ladder_kernel.point_multiply_cuda(peer_pk, sk, zr=zr,
                                             device=device)
