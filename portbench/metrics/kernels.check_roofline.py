"""Ed25519 verify_check's share of its frozen bound: the bound of a token
batch's work (SHA-512 of R || A || M and the double-scalar multiply against
the issuer key's cached q_table) over the device time of the hand-written
kernels that call launched (pack_words_kernel, sha512_kernel,
poly_shared_kernel), percent."""


def read(reading):
    return reading.roofline("verify_check")
