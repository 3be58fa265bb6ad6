"""Device milliseconds a packet batch spends in glue: PyTorch's own kernels
(SHA-512 word packing, from_digest, digit cuts, the verdict) and every copy
and set, the copy of the packets in included."""


def read(reading):
    return reading.glue_ms()
