"""Ed25519 sign's share of its frozen bound: the bound of a batch's sign
work (SHA-512, fold-8 base multiply, mod-l steps) over the device time of
the hand-written kernels that call launched (sign_kernel), percent."""


def read(reading):
    return reading.roofline("sign")
