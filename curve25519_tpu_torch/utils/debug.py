"""Hex dumps for failure paths (counterpart of
curve25519_tpu/utils/debug.py; the reference's ecp_PrintHexBytes,
ecp_PrintHexWords, ecp_PrintBytes and ecp_PrintWords).

Each takes bytes, numpy arrays or tensors on any device and gives the same
strings as the JAX package's; a batched input gives one line per lane.
`hex_fe` renders limb rows as the integer they encode.
"""

import numpy as np
import torch

__all__ = ["hex_bytes", "hex_words", "hex_fe", "print_hex_bytes",
           "print_hex_words", "print_fe"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (bytes, bytearray)):
        return np.frombuffer(bytes(x), np.uint8)
    return np.asarray(x)


def _named(s, name):
    return "%s = %s" % (name, s) if name else s


def _rows(fn, a, name, *args):
    return "\n".join(fn(row, "%s[%d]" % (name, i) if name else None, *args)
                     for i, row in enumerate(a))


def hex_bytes(x, name=None):
    """Little-endian byte strings as 0x... most significant byte first
    (the reference's `name = 0x...` format)."""
    a = _np(x).astype(np.uint8, copy=False)
    if a.ndim > 1:
        return _rows(hex_bytes, a, name)
    return _named("0x" + "".join("%02X" % b for b in a[::-1]), name)


def hex_words(x, name=None):
    """32-bit word arrays as 0x..., most significant word first."""
    a = np.asarray(_np(x), dtype=np.uint64)
    if a.ndim > 1:
        return _rows(hex_words, a, name)
    return _named("0x" + "".join("%08X" % int(w) for w in a[::-1]), name)


def hex_fe(limbs, name=None, radix_bits=13):
    """Limb rows as the integer they encode (no reduction: a weakly
    normalized value shows its raw sum)."""
    a = np.asarray(_np(limbs), dtype=object)
    if a.ndim > 1:
        return _rows(hex_fe, a, name, radix_bits)
    return _named(hex(sum(int(v) << (radix_bits * i)
                          for i, v in enumerate(a))), name)


def print_hex_bytes(x, name=None):
    print(hex_bytes(x, name))


def print_hex_words(x, name=None):
    print(hex_words(x, name))


def print_fe(limbs, name=None):
    print(hex_fe(limbs, name))
