"""Ed25519 verify_cached's share of its frozen bound: the bound of a vote
batch's work (SHA-512 of R || A || M, the double-scalar multiply against
the staked key's cached q_table, and Verify_Init with it for the votes of
keys outside the table) over the device time of the hand-written kernels
that call launched (pack_words_kernel, sha512_kernel, digits_kernel,
key_lookup_kernel, poly_keyed_kernel), percent."""


def read(reading):
    return reading.roofline("verify_cached")
