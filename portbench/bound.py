"""The frozen bound model: the least time one NVIDIA H100 SXM could take for
the work of a call, from counts of the algorithm's operations and the card's
rates, all fixed here so that a share read in one run compares with a share
read in another.

The least time is the larger of the bytes (each input read once, each
output written once, at HBM's 3.35 TB/s) and the operations, each kind at
its pipe's rate:

- The field and scalar work, counted as the exact products each operation
  needs on either of the card's two exact multipliers, whatever radix a
  kernel uses inside:
  - the integer pipe, 32x32->64 products (mul.wide.u32) on 32-bit words
    with one Karatsuba level: a multiply mod p is 3 x 16 products of 4-word
    halves plus 9 for the fold of its high half by 2^256 = 38 (mod p); a
    squaring 3 x 10 + 9; a multiply by a small constant 8 + 1;
  - the FP64 pipe (fma.rn.f64), whose product of two balanced limbs of
    radix 2^25.5 is exact: a multiply is 10 x 10 products plus 9 for the
    fold by 2^255 = 19; a squaring 55 + 9; a small constant 10 + 1.
  A mod-l multiply is a multiply plus the reduction of its 512 bits by
  l = 2^252 + d: (9 + 5 + 1) x 4 integer or (10 + 6 + 1) x 5 FP64
  products. The two pipes run at once and each operation may go to either:
  the field time is the least over all such splits.
- SHA-512's 64-bit rounds and schedule as int32 logic, shift and add
  operations (3,968 a block) on the ALU pipe.

Not counted: additions, carries, moves, loads, issue slots, table gathers
(which count an implementation, not the algorithm), the FP32 pipe and the
tensor cores. So the bound lies below the least time on these pipes, and a
share of it cannot pass 100% unless a count here is wrong.

Rates: fma.rn.f64 at 64 per clock per SM (the data sheet's 34 TFLOP/s of
FP64 at 132 SMs and 1,980 MHz); mul.wide.u32 at 31.33 per clock per SM (a
rate measured on an H100 80GB HBM3 by a microkernel: there is no published
figure); the ALU pipe at 64 per clock per SM; all at the maximum SM clock of
1,980 MHz over 132 SMs.
"""

from collections import Counter

SMS = 132
CLOCK_HZ = 1.98e9
MULWIDE_PER_S = 31.33 * SMS * CLOCK_HZ
DFMA_PER_S = 64 * SMS * CLOCK_HZ
ALU_PER_S = 64 * SMS * CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12

PRODUCTS = {            # (32x32->64 integer, FP64) products per operation
    "mul": (3 * 16 + 9, 10 * 10 + 9),
    "sqr": (3 * 10 + 9, 55 + 9),
    "small": (8 + 1, 10 + 1),
    "sc_reduce": ((9 + 5 + 1) * 4, (10 + 6 + 1) * 5),
    "sc_mul": (3 * 16 + (9 + 5 + 1) * 4, 10 * 10 + (10 + 6 + 1) * 5),
}
INV = Counter(sqr=254, mul=11)           # the 254 S + 11 M inversion chain
SHA_BLOCK_ALU = 80 * 32 + 64 * 22        # 64-bit rounds and schedule


def sha_blocks(length):
    """SHA-512 blocks of a message of `length` bytes, padding included."""
    return (length + 17 + 127) // 128


def ladder_ops():
    """X25519: 254 steps of 5 M + 4 S + 1 small, the start 3 M + 2 S + 1
    small, the inversion. Returns (field operation -> count, ALU) a lane."""
    return Counter(mul=254 * 5 + 3, sqr=254 * 4 + 2, small=255) + INV, 0


def basemult_ops(nfolds):
    """A base multiply by folding (32 steps for nfolds = 8) with its
    epilogue: one inversion and two multiplies."""
    steps = 256 // nfolds - 1
    return Counter(mul=4 + steps * 11 + 2, sqr=steps * 4) + INV, 0


def sign_ops(blocks):
    """An Ed25519 signature: the key's hash (one block), the two message
    hashes (`blocks` together), the base multiply (fold 8) and the mod-l
    steps."""
    field, alu = basemult_ops(8)
    return (field + Counter(sc_reduce=2, sc_mul=1),
            alu + (1 + blocks) * SHA_BLOCK_ALU)


def verify_init_ops():
    """Decompression (sqrt ratio and x*y: 20 M, 256 S), 192 doublings, 15
    PE conversions and 11 PE adds."""
    return Counter(mul=20 + 192 * 4 + 15 + 11 * 8, sqr=256 + 192 * 4), 0


def poly_ops():
    """63 doublings, 63 PE adds, 32 PA adds, the start's and the epilogue's
    multiplies and one inversion."""
    return Counter(mul=63 * 4 + 63 * 8 + 32 * 7 + 3, sqr=63 * 4) + INV, 0


def verify_ops(blocks):
    """One-shot verification of a lane whose hash R || A || M takes
    `blocks` SHA-512 blocks."""
    (f1, _), (f2, _) = verify_init_ops(), poly_ops()
    return f1 + f2, blocks * SHA_BLOCK_ALU


def field_s(field):
    """The least seconds of the field work (operation -> count) with both
    multipliers at once and each operation on either: for a time t the
    integer pipe takes the operations that save the most FP64 products per
    integer product first; bisection finds the least t whose remainder
    fits the FP64 pipe."""
    kinds = sorted(field, key=lambda k: PRODUCTS[k][1] / PRODUCTS[k][0],
                   reverse=True)

    def fits(t):
        room, fp64 = MULWIDE_PER_S * t, 0.0
        for k in kinds:
            on_int = min(field[k], room / PRODUCTS[k][0])
            room -= on_int * PRODUCTS[k][0]
            fp64 += (field[k] - on_int) * PRODUCTS[k][1]
        return fp64 <= DFMA_PER_S * t

    lo, hi = 0.0, sum(n * PRODUCTS[k][0] for k, n in field.items()) \
        / MULWIDE_PER_S
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (lo, mid) if fits(mid) else (mid, hi)
    return hi


def seconds(work):
    """The bound in seconds of a list of (ops, lanes, bytes): ops as
    (field operation -> count, ALU) a lane for `lanes` lanes, and the bytes
    the call reads and writes. All the work is one call's, so the pipes
    overlap: the bound is the larger of the summed field time, ALU time and
    byte time."""
    field, alu, nbytes = Counter(), 0.0, 0
    for (f, a), lanes, b in work:
        for k, n in f.items():
            field[k] += lanes * n
        alu += lanes * a
        nbytes += b
    return max(field_s(field), alu / ALU_PER_S, nbytes / HBM_BYTES_PER_S)
