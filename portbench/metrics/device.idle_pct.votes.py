"""The share of a vote cell's traced window in which the card ran no
kernel, copy or set: 100 less the union of the device-busy intervals over
the window, percent."""


def read(reading):
    return reading.idle_pct()
