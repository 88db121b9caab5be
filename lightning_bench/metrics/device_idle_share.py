"""Share of the profiled slice in which no operation ran on the device,
in %."""


def read(r):
    if not r.device or not r.device["window_s"] or not r.device["ops"]:
        return None
    return 100.0 * (1.0 - r.device["busy_s"] / r.device["window_s"])
