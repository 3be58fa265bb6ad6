"""Device milliseconds a handshake batch spends in glue: PyTorch's own
kernels (word packing, fold cuts, clamps, broadcasts) and every copy and
set, the host-device copies included."""


def read(reading):
    return reading.glue_ms()
