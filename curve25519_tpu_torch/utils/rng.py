"""Hardened random bytes (counterpart of curve25519_tpu/utils/rng.py).

OS entropy post-whitened through SHA-512 keyed with a package-local secret,
so a weak OS generator still gives unpredictable output (the reference's
"paranoid" RNG). The same construction as the JAX package's, so the same
OS bytes and clock give the same output. It runs on the host core's
streaming SHA-512 (ops/sha512.Sha512()); the custom tool and the OO
wrapper's random keys use it.
"""

import os
import struct
import time

__all__ = ["get_random_bytes"]

_POOL_KEY = b"curve25519-tpu/hardened-rng/v1"


def get_random_bytes(n: int) -> bytes:
    """n hardened random bytes (64 per SHA-512 round)."""
    from curve25519_tpu_torch.ops.sha512 import Sha512
    out = bytearray()
    counter = 0
    while len(out) < n:
        h = Sha512()
        h.update(_POOL_KEY)
        h.update(os.urandom(64))
        h.update(struct.pack("<dQ", time.time(), counter))
        out += h.final()
        counter += 1
    return bytes(out[:n])
