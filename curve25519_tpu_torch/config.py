"""Constants of the PyTorch port (counterpart of curve25519_tpu/config.py).

The port keeps the reference's field representation so that its limbs can be
compared with the JAX package's bit for bit: 20 limbs of radix 2^13 in int32,
with the 2^260 = 608 (mod p) wrap fold. See curve25519_tpu/config.py for the
radix rationale and the bound argument.

This module is a standalone copy (numpy only) so that the port imports
nothing of the JAX package; tests/test_torch_fe.py holds it equal to the
original.
"""

import numpy as np

__all__ = ["P", "ELL", "BITS", "NLIMBS", "MASK", "FOLD", "A24",
           "MONT_BASE_U", "SQRT_M1", "ED_D", "ED_2D", "ED_DI", "ED_BX",
           "ED_BY", "int_to_limbs", "limbs_to_int"]

P = 2**255 - 19

# Base point order l = 2^252 + 27742317777372353535851937790883648493
ELL = 2**252 + 27742317777372353535851937790883648493

BITS = 13
NLIMBS = 20
MASK = (1 << BITS) - 1
TOTAL_BITS = BITS * NLIMBS

# 2^260 mod p: the wrap fold of the top carry back into limb 0
FOLD = (1 << TOTAL_BITS) % P
assert FOLD == 608

# Montgomery ladder constant (A - 2) / 4
A24 = 121665

# sqrt(-1) mod p (square-root fix-up of fe.sqrt_ratio)
SQRT_M1 = pow(2, (P - 1) // 4, P)

# X25519 base point u-coordinate
MONT_BASE_U = 9

# Edwards curve constant d = -121665/121666 mod p, 2d and 1/d
ED_D = (-121665 * pow(121666, P - 2, P)) % P
ED_2D = (2 * ED_D) % P
ED_DI = pow(ED_D, P - 2, P)

# Ed25519 base point: y = 4/5 mod p, x = the even root
ED_BY = (4 * pow(5, P - 2, P)) % P
_x2 = ((ED_BY * ED_BY - 1) * pow(ED_D * ED_BY * ED_BY + 1, P - 2, P)) % P
_x = pow(_x2, (P + 3) // 8, P)
if (_x * _x - _x2) % P != 0:
    _x = (_x * SQRT_M1) % P
if _x % 2 != 0:
    _x = P - _x
ED_BX = _x
assert ED_BX == 0x216936D3CD6E53FEC0A4E231FDD6DC5C692CC7609525A7B2C9562D608F25D51A
assert ED_BY == 0x6666666666666666666666666666666666666666666666666666666666666658


def int_to_limbs(x: int, n: int = NLIMBS) -> np.ndarray:
    """Split a non-negative python int into n base-2^BITS limbs (int32)."""
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & MASK
        x >>= BITS
    if x != 0:
        raise ValueError("value does not fit in %d limbs" % n)
    return out


def limbs_to_int(limbs) -> int:
    """Reassemble a limb vector (any integer dtype, possibly unnormalized)."""
    limbs = np.asarray(limbs)
    return sum(int(v) << (BITS * i) for i, v in enumerate(limbs.tolist()))
