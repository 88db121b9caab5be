"""The device's peak allocation from the placed data through the end of
the window, on the fullest card, in GB (1e9 bytes)."""


def read(r):
    return None if r.peak_bytes is None else r.peak_bytes / 1e9
