"""ctypes bindings of the port's host core (counterpart of
curve25519_tpu/native/bindings.py).

ref25519.cpp is a byte-equal copy of the JAX package's host core: radix
2^51 field arithmetic, SHA-512 (one-shot and streaming), the X25519 ladder,
Ed25519 keygen, sign and verify, behind a plain C interface. g++ compiles it
at first use into ``_build/`` beside this file (git-ignored), and again when
the source is newer than the library. A failed build raises; nothing falls
back to another route.
"""

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load", "x25519", "x25519_base", "x25519_base_fast", "sha512",
           "Sha512Stream", "ed25519_keypair", "ed25519_keypair_fast",
           "ed25519_sign", "ed25519_sign_fast", "ed25519_verify"]

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "ref25519.cpp"
BUILD_DIR = _DIR / "_build"
_SO = BUILD_DIR / "libref25519.so"

_u8p = ctypes.POINTER(ctypes.c_uint8)
_vp, _u64 = ctypes.c_void_p, ctypes.c_uint64
_ARGTYPES = {
    "c25519_x25519": [_u8p, _u8p, _u8p],
    "c25519_x25519_base": [_u8p, _u8p],
    "c25519_x25519_base_fast": [_u8p, _u8p],
    "c25519_sha512": [_u8p, _u8p, _u64],
    "c25519_ed25519_keypair": [_u8p, _u8p, _u8p],
    "c25519_ed25519_keypair_fast": [_u8p, _u8p, _u8p],
    "c25519_ed25519_sign": [_u8p, _u8p, _u8p, _u64],
    "c25519_ed25519_sign_fast": [_u8p, _u8p, _u8p, _u64],
    "c25519_ed25519_verify": [_u8p, _u8p, _u8p, _u64],
    "c25519_sha512_ctx_size": [],
    "c25519_sha512_init": [_vp],
    "c25519_sha512_update": [_vp, _u8p, _u64],
    "c25519_sha512_final": [_vp, _u8p],
}


def _build():
    """g++ into a temporary name, then an atomic rename: processes that
    build at the same time each leave a whole library."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host core cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(".so.tmp%d" % os.getpid())
    proc = subprocess.run([gxx, "-O3", "-march=native", "-shared", "-fPIC",
                           "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ failed to build %s:\n%s"
                           % (_SRC.name, proc.stderr))
    os.replace(tmp, _SO)


@functools.cache
def load():
    """The host core as a ctypes CDLL (built if missing or stale), argument
    and return types declared."""
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _build()
    lib = ctypes.CDLL(str(_SO))
    for name, argtypes in _ARGTYPES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = None
    lib.c25519_ed25519_verify.restype = ctypes.c_int
    lib.c25519_sha512_ctx_size.restype = ctypes.c_uint64
    return lib


def _buf(data: bytes, n=None):
    """A ctypes copy of data (one byte for an empty message), checked
    against the n bytes the C side reads."""
    data = bytes(data)
    if n is not None and len(data) != n:
        raise ValueError("expected %d bytes, got %d" % (n, len(data)))
    return (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(
        data or b"\0")


def _out(n):
    return (ctypes.c_uint8 * n)()


def x25519(sk: bytes, peer_pk: bytes) -> bytes:
    """The X25519 shared secret of a 32-byte secret and peer public key."""
    out = _out(32)
    load().c25519_x25519(out, _buf(peer_pk, 32), _buf(sk, 32))
    return bytes(out)


def x25519_base(sk: bytes) -> bytes:
    """The X25519 public key by the ladder from u = 9."""
    out = _out(32)
    load().c25519_x25519_base(out, _buf(sk, 32))
    return bytes(out)


def x25519_base_fast(sk: bytes) -> bytes:
    """The X25519 public key by the folding-8 Edwards multiply and the
    birational map; equal to x25519_base."""
    out = _out(32)
    load().c25519_x25519_base_fast(out, _buf(sk, 32))
    return bytes(out)


def sha512(msg: bytes) -> bytes:
    out = _out(64)
    load().c25519_sha512(out, _buf(msg), len(msg))
    return bytes(out)


class Sha512Stream:
    """Streaming SHA-512 on the host core: O(1) memory (the C context of
    c25519_sha512_ctx_size() bytes), any stream up to 2^64 - 1 bytes."""

    def __init__(self):
        self._lib = load()
        self.ctx_size = int(self._lib.c25519_sha512_ctx_size())
        self._ctx = ctypes.create_string_buffer(self.ctx_size)
        self._lib.c25519_sha512_init(self._ptr())

    def _ptr(self):
        return ctypes.cast(self._ctx, ctypes.c_void_p)

    def update(self, data):
        data = bytes(data)
        if data:
            # no copy: the C side reads the bytes object's own buffer
            p = ctypes.cast(ctypes.c_char_p(data), _u8p)
            self._lib.c25519_sha512_update(self._ptr(), p, len(data))
        return self

    def final(self) -> bytes:
        out = _out(64)
        self._lib.c25519_sha512_final(self._ptr(), out)
        return bytes(out)


def ed25519_keypair(sk: bytes):
    """(pk, priv = sk || pk) of a 32-byte seed."""
    pk, priv = _out(32), _out(64)
    load().c25519_ed25519_keypair(pk, priv, _buf(sk, 32))
    return bytes(pk), bytes(priv)


def ed25519_keypair_fast(sk: bytes):
    """Folding-8 keygen; equal to ed25519_keypair."""
    pk, priv = _out(32), _out(64)
    load().c25519_ed25519_keypair_fast(pk, priv, _buf(sk, 32))
    return bytes(pk), bytes(priv)


def ed25519_sign(priv: bytes, msg: bytes) -> bytes:
    sig = _out(64)
    load().c25519_ed25519_sign(sig, _buf(priv, 64), _buf(msg), len(msg))
    return bytes(sig)


def ed25519_sign_fast(priv: bytes, msg: bytes) -> bytes:
    """Folding-8 sign; equal to ed25519_sign."""
    sig = _out(64)
    load().c25519_ed25519_sign_fast(sig, _buf(priv, 64), _buf(msg), len(msg))
    return bytes(sig)


def ed25519_verify(sig: bytes, pk: bytes, msg: bytes) -> bool:
    return bool(load().c25519_ed25519_verify(_buf(sig, 64), _buf(pk, 32),
                                             _buf(msg), len(msg)))
