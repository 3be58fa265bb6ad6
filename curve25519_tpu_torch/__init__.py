"""curve25519_tpu_torch — the PyTorch / CUDA port of curve25519_tpu.

Plain functions on torch tensors with the JAX package's layouts: ``[..., 32]``
uint8 byte strings and ``[..., 20]`` int32 field limbs. A CUDA tensor runs
the hand-written Hopper kernels under ``ops/cuda``; a CPU tensor runs their
plain PyTorch versions. The package imports neither jax nor curve25519_tpu.
"""

__version__ = "0.1.0"

from curve25519_tpu_torch.config import (  # noqa: F401
    A24, BITS, FOLD, MASK, MONT_BASE_U, NLIMBS, P, int_to_limbs,
    limbs_to_int,
)
