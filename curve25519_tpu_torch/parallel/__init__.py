"""Batch sharding over devices and processes (counterpart of
curve25519_tpu/parallel)."""

from curve25519_tpu_torch.parallel import mesh  # noqa: F401
