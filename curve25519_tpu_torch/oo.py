"""Object-oriented wrapper (counterpart of curve25519_tpu/oo.py; the
reference's C++ classes): `X25519Private`, `ED25519Private` and
`ED25519Public`, single keys with Python bytes in and out, random keys from
the hardened RNG, and the SHA-512 KDF that the C++ wrapper applies to a raw
X25519 shared secret (the first 32 bytes of SHA-512 of it).

Each class takes the route of the port's device rule:
- `native=None` or `False`: the port's batched API at B = 1, on the card or
  on `device=` (`device="cpu"` runs the plain versions). Keygen and sign use
  dedicated blinding contexts derived from the hardened RNG, one pair per
  device; the KDF is the batched SHA-512 on the same device.
- `native=True`: the port's host core (native/), unblinded; a failed build
  raises. Its KDF is the host core's SHA-512.

Both routes give the same bytes: neither signatures nor keys depend on
blinding. `ED25519Public` builds its verify context on first use and keeps
it, like the reference's EDP_SIGV_CTX.
"""

import functools

import torch

from curve25519_tpu_torch.ops.cuda import pick_device
from curve25519_tpu_torch.utils.rng import get_random_bytes

__all__ = ["X25519Private", "ED25519Private", "ED25519Public"]


@functools.cache
def _blinds(device):
    """(keygen context, sign context) of a device, derived once."""
    from curve25519_tpu_torch.models import blinding
    return (blinding.blinding_init(b"oo/genkey/" + get_random_bytes(32),
                                   device=device),
            blinding.blinding_init(b"oo/sign/" + get_random_bytes(32),
                                   device=device))


def _tensor(data: bytes, device):
    return torch.tensor(list(data), dtype=torch.uint8, device=device)


def _bytes(t) -> bytes:
    return bytes(t.reshape(-1).cpu().tolist())


class _Route:
    """native=True: the host core's bindings; else the device of the
    batched route."""

    def __init__(self, native, device):
        if native:
            from curve25519_tpu_torch.native import bindings
            bindings.load()
            self._nb, self._dev = bindings, None
        else:
            self._nb, self._dev = None, pick_device(device=device)

    def _kdf(self, raw: bytes) -> bytes:
        if self._nb is not None:
            return self._nb.sha512(raw)[:32]
        from curve25519_tpu_torch.ops.sha512 import sha512_bytes
        return sha512_bytes(raw, device=self._dev)[:32]


class X25519Private(_Route):
    """X25519 private key (reference class X25519Private)."""

    def __init__(self, secret: bytes = None, native: bool = None,
                 device=None):
        super().__init__(native, device)
        self._sk = secret if secret is not None else get_random_bytes(32)

    def get_public_key(self) -> bytes:
        if self._nb is not None:
            return self._nb.x25519_base_fast(self._sk)
        from curve25519_tpu_torch.models import x25519
        return _bytes(x25519.calculate_public_key(_tensor(self._sk,
                                                          self._dev)))

    def create_shared_key(self, peer_public_key: bytes,
                          kdf: bool = True) -> bytes:
        if self._nb is not None:
            raw = self._nb.x25519(self._sk, peer_public_key)
        else:
            from curve25519_tpu_torch.models import x25519
            raw = _bytes(x25519.create_shared_key(
                _tensor(peer_public_key, self._dev),
                _tensor(self._sk, self._dev)))
        return self._kdf(raw) if kdf else raw


class ED25519Private(_Route):
    """Ed25519 signing key (reference class ED25519Private)."""

    def __init__(self, secret: bytes = None, native: bool = None,
                 device=None):
        super().__init__(native, device)
        seed = secret if secret is not None else get_random_bytes(32)
        if self._nb is not None:
            self._pk, self._priv = self._nb.ed25519_keypair_fast(seed)
            return
        from curve25519_tpu_torch.models import ed25519
        pk, priv = ed25519.create_keypair(_tensor(seed, self._dev),
                                          blinding=_blinds(self._dev)[0])
        self._pk, self._priv = _bytes(pk), _bytes(priv)

    def get_public_key(self) -> bytes:
        return self._pk

    def sign(self, message: bytes) -> bytes:
        if self._nb is not None:
            return self._nb.ed25519_sign_fast(self._priv, message)
        from curve25519_tpu_torch.models import ed25519
        return _bytes(ed25519.sign(_tensor(self._priv, self._dev),
                                   _tensor(message, self._dev),
                                   blinding=_blinds(self._dev)[1]))


class ED25519Public(_Route):
    """Ed25519 verification key (reference class ED25519Public)."""

    def __init__(self, public_key: bytes, native: bool = None, device=None):
        super().__init__(native, device)
        self._pk = public_key
        self._ctx = None

    def get_public_key(self) -> bytes:
        return self._pk

    def verify(self, signature: bytes, message: bytes) -> bool:
        if self._nb is not None:
            return self._nb.ed25519_verify(signature, self._pk, message)
        from curve25519_tpu_torch.models import ed25519
        if self._ctx is None:
            self._ctx = ed25519.verify_init(_tensor(self._pk, self._dev))
        return bool(ed25519.verify_check(self._ctx,
                                         _tensor(signature, self._dev),
                                         _tensor(message, self._dev)).item())
