"""The X25519 ladder's share of its frozen bound: the bound of a batch's
create_shared_key work over the device time of the hand-written kernels
that call launched (x25519_ladder_kernel), percent."""


def read(reading):
    return reading.roofline("create_shared_key")
