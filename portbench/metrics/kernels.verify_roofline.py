"""Ed25519 verify's share of its frozen bound: the bound of a batch's
verify work (SHA-512 of R || A || M, Verify_Init and the double-scalar
multiply) over the device time of the hand-written kernels that call
launched (sha512_kernel, oneshot_kernel), percent."""


def read(reading):
    return reading.roofline("verify")
