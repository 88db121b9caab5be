"""The HotSpot kernel's share of its roofline in the profiled slice, in %."""

from lightning_bench.harness.peaks import kernel_roofline


def read(r):
    return kernel_roofline(r, "hotspot")
