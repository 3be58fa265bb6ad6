"""Device milliseconds a vote batch spends in glue: PyTorch's own kernels
(the hash prefix, the key lookup, the ordering of the misses first, the
verdict) and every copy and set, the copy of the votes in included."""


def read(reading):
    return reading.glue_ms()
