"""Device milliseconds a token batch spends in glue: PyTorch's own kernels
(the hash prefix, from_digest, digit cuts, the strict verdict) and every
copy and set, the copy of the tokens in included."""


def read(reading):
    return reading.glue_ms()
