"""Plain reference of X25519 (RFC 7748) and Ed25519 (RFC 8032) on Python
integers and hashlib. It imports nothing of the program under test.

Verification follows the decode rules the port documents for
`strict=False` (models/ed25519.py of the port): a y >= p decodes as y - p,
x = 0 with the sign bit set is accepted, S >= l is accepted and used as it
is, and R' = enc(S*B - h*A) is compared with R as encodings.

Points are extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z and
T = XY/Z. Fixed-base multiplies use a 4-bit comb of 64 x 16 affine
multiples of B, built at first use; variable-base multiplies use a 4-bit
window. Nothing here is constant time: it is a judge, not a signer of
secrets.
"""

import functools
import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
A24 = 121665


def _sqrt_ratio_x(y):
    """x with x^2 = (y^2 - 1) / (d y^2 + 1), the even root, or None."""
    u, v = (y * y - 1) % P, (D * y * y + 1) % P
    x2 = u * pow(v, P - 2, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    return P - x if x & 1 else x


BASE_Y = 4 * pow(5, P - 2, P) % P
BASE_X = _sqrt_ratio_x(BASE_Y)
BASE = (BASE_X, BASE_Y, 1, BASE_X * BASE_Y % P)
IDENTITY = (0, 1, 1, 0)


# ---------------------------------------------------------------------------
# X25519 (RFC 7748 section 5)
# ---------------------------------------------------------------------------
def clamp(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] = (b[31] & 127) | 64
    return int.from_bytes(b, "little")


def x25519(k: bytes, u: bytes) -> bytes:
    """X25519(k, u): the Montgomery ladder of RFC 7748 section 5."""
    k = clamp(k)
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    x2, z2, x3, z3, swap = 1, 0, x1, 1, 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        if swap ^ kt:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = kt
        a, b = x2 + z2, x2 - z2
        aa, bb = a * a % P, b * b % P
        e = aa - bb
        c, d = x3 + z3, x3 - z3
        da, cb = d * a % P, c * b % P
        x3, z3 = (da + cb) ** 2 % P, x1 * (da - cb) ** 2 % P
        x2, z2 = aa * bb % P, e * (aa + A24 * e) % P
    if swap:
        x2, z2 = x3, z3
    return (x2 * pow(z2, P - 2, P) % P).to_bytes(32, "little")


def x25519_base(k: bytes) -> bytes:
    """X25519(k, 9), through the birational map u = (1 + y) / (1 - y) of
    clamp(k) * B on the Edwards curve."""
    _, y, z, _ = base_mult(clamp(k))
    return ((z + y) * pow(z - y, P - 2, P) % P).to_bytes(32, "little")


# ---------------------------------------------------------------------------
# Edwards25519 points (RFC 8032 section 5.1.4)
# ---------------------------------------------------------------------------
def add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % P, g * h % P, f * g % P, e * h % P


def double(p):
    x1, y1, z1, _ = p
    a, b = x1 * x1 % P, y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = h - (x1 + y1) ** 2 % P
    g = a - b
    f = c + g
    return e * f % P, g * h % P, f * g % P, e * h % P


def add_niels(p, n):
    """p + q for q given as (y + x, y - x, 2d x y) of its affine form."""
    x1, y1, z1, t1 = p
    ypx, ymx, xy2d = n
    a = (y1 - x1) * ymx % P
    b = (y1 + x1) * ypx % P
    c = t1 * xy2d % P
    d = 2 * z1
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % P, g * h % P, f * g % P, e * h % P


def niels(p):
    x, y = affine(p)
    return (y + x) % P, (y - x) % P, D2 * x * y % P


@functools.cache
def _comb():
    """comb[i][j] = j * 16^i * B as niels triples, j = 1..15 (j = 0 is
    left out: the identity is skipped)."""
    rows, base = [], BASE
    for _ in range(64):
        row, acc = [], base
        for _ in range(15):
            row.append(niels(acc))
            acc = add(acc, base)
        rows.append(row)
        base = acc                            # 16 * base
    return rows


def base_mult(k: int):
    """k * B for 0 <= k < 2^256, by the comb."""
    comb, acc = _comb(), IDENTITY
    for i in range(64):
        j = (k >> (4 * i)) & 15
        if j:
            acc = add_niels(acc, comb[i][j - 1])
    return acc


def mult(k: int, p):
    """k * p for 0 <= k < 2^256, by a 4-bit window from the top."""
    table = [IDENTITY, p]
    for _ in range(14):
        table.append(add(table[-1], p))
    acc = IDENTITY
    for i in range(63, -1, -1):
        acc = double(double(double(double(acc))))
        j = (k >> (4 * i)) & 15
        if j:
            acc = add(acc, table[j])
    return acc


def affine(p):
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def encode_many(points):
    """encode() of each point, with one inversion for all (Montgomery's
    trick)."""
    prefix, acc = [], 1
    for p in points:
        prefix.append(acc)
        acc = acc * p[2] % P
    inv = pow(acc, P - 2, P)
    out = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        x, y, z, _ = points[i]
        zi = inv * prefix[i] % P
        inv = inv * z % P
        x, y = x * zi % P, y * zi % P
        out[i] = (y | (x & 1) << 255).to_bytes(32, "little")
    return out


def encode(p) -> bytes:
    x, y = affine(p)
    return (y | (x & 1) << 255).to_bytes(32, "little")


def decode(b: bytes):
    """The point of a 32-byte encoding under the port's lenient rules, or
    None when y has no x on the curve."""
    v = int.from_bytes(b, "little")
    y = (v & ((1 << 255) - 1)) % P
    x = _sqrt_ratio_x(y)
    if x is None:
        return None
    if (x & 1) != v >> 255:
        x = (P - x) % P
    return x, y, 1, x * y % P


# ---------------------------------------------------------------------------
# Ed25519 (RFC 8032 section 5.1)
# ---------------------------------------------------------------------------
def _hint(data: bytes) -> int:
    return int.from_bytes(hashlib.sha512(data).digest(), "little")


def secret_scalar(seed: bytes):
    """(a, prefix) of a 32-byte secret seed."""
    h = hashlib.sha512(seed).digest()
    return clamp(h[:32]), h[32:]


def public_key(seed: bytes) -> bytes:
    return encode(base_mult(secret_scalar(seed)[0]))


def sign(seed: bytes, msg: bytes) -> bytes:
    a, prefix = secret_scalar(seed)
    return sign_with(a, prefix, encode(base_mult(a)), msg)


def sign_with(a: int, prefix: bytes, pk: bytes, msg: bytes) -> bytes:
    """The signature of msg by the key (a, prefix) whose public key is
    pk."""
    r = _hint(prefix + msg) % L
    big_r = encode(base_mult(r))
    s = (r + _hint(big_r + pk + msg) % L * a) % L
    return big_r + s.to_bytes(32, "little")


def challenge(big_r: bytes, pk: bytes, msg: bytes) -> int:
    """h = SHA-512(R || A || M) mod l."""
    return _hint(big_r + pk + msg) % L


def verify(sig: bytes, pk: bytes, msg: bytes, strict=False) -> bool:
    q = decode(pk)
    s = int.from_bytes(sig[32:], "little")
    if q is None or (strict and s >= L):
        return False
    h = challenge(sig[:32], pk, msg)
    neg_q = ((P - q[0]) % P, q[1], 1, (P - q[3]) % P)
    return encode(add(base_mult(s), mult(h, neg_q))) == sig[:32]
