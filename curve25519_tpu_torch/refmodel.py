"""Pure-Python reference model: host-side oracle and table generator
(counterpart of curve25519_tpu/refmodel.py, copied so that the port imports
nothing of the JAX package).

Plain Python big-int arithmetic and hashlib, sharing no code with the
tensor paths. The port uses it to generate the folding tables
(models/tables.py) and the host-side blinding contexts
(models/blinding.py); the tests use it as an oracle.
"""

import hashlib

from curve25519_tpu_torch.config import ED_BX, ED_BY, ED_D, ELL, P

__all__ = [
    "ed_add", "ed_double", "scalar_mult", "base_mult", "compress",
    "decompress", "x25519", "x25519_base", "ed_keypair", "ed_sign",
    "ed_verify", "BASE", "IDENTITY",
]

BASE = (ED_BX, ED_BY)
IDENTITY = (0, 1)


def _inv(x):
    return pow(x, P - 2, P)


def ed_add(p, q):
    """Affine twisted-Edwards addition (complete formulas)."""
    x1, y1 = p
    x2, y2 = q
    k = ED_D * x1 * x2 * y1 * y2 % P
    x3 = (x1 * y2 + x2 * y1) * _inv(1 + k) % P
    y3 = (y1 * y2 + x1 * x2) * _inv(1 - k) % P
    return (x3, y3)


def ed_double(p):
    return ed_add(p, p)


def scalar_mult(k, p):
    r = IDENTITY
    while k:
        if k & 1:
            r = ed_add(r, p)
        p = ed_double(p)
        k >>= 1
    return r


def base_mult(k):
    return scalar_mult(k, BASE)


def compress(p) -> bytes:
    x, y = p
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decompress(b: bytes):
    v = int.from_bytes(b, "little")
    y = v & ((1 << 255) - 1)
    parity = v >> 255
    x2 = (y * y - 1) * _inv(ED_D * y * y + 1) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P:
        return None
    if x & 1 != parity:
        x = P - x
    return (x, y)


def _clamp(sk: bytes) -> int:
    k = bytearray(sk)
    k[0] &= 0xF8
    k[31] = (k[31] | 0x40) & 0x7F
    return int.from_bytes(bytes(k), "little")


def x25519(sk: bytes, peer_u: bytes) -> bytes:
    """RFC 7748 X25519 (Montgomery ladder on Python ints)."""
    k = _clamp(sk)
    u = int.from_bytes(peer_u, "little") & ((1 << 255) - 1)
    x1, x2, z2, x3, z3 = u, 1, 0, u, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        if swap ^ kt:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = x1 * z3 * z3 % P
        x2 = aa * bb % P
        z2 = e * (aa + 121665 * e) % P
    if swap:
        x2, z2 = x3, z3
    return (x2 * _inv(z2) % P).to_bytes(32, "little")


def x25519_base(sk: bytes) -> bytes:
    return x25519(sk, (9).to_bytes(32, "little"))


def ed_keypair(sk: bytes):
    """RFC 8032 Ed25519 key pair: (pk, sk || pk)."""
    md = hashlib.sha512(sk[:32]).digest()
    a = _clamp(md[:32])
    pk = compress(base_mult(a))
    return pk, sk[:32] + pk


def ed_sign(priv: bytes, msg: bytes) -> bytes:
    md = hashlib.sha512(priv[:32]).digest()
    a = _clamp(md[:32])
    prefix = md[32:]
    pk = priv[32:64]
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % ELL
    R = compress(base_mult(r))
    h = int.from_bytes(hashlib.sha512(R + pk + msg).digest(), "little") % ELL
    s = (r + h * a) % ELL
    return R + s.to_bytes(32, "little")


def ed_verify(sig: bytes, pk: bytes, msg: bytes) -> bool:
    q = decompress(pk)
    if q is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= ELL:
        return False
    h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(),
                       "little") % ELL
    neg_q = (P - q[0], q[1])
    rp = ed_add(base_mult(s), scalar_mult(h, neg_q))
    return compress(rp) == sig[:32]
