"""The table of device peaks that rooflines are taken against.

NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power limit:
67 TFLOP/s of f32 outside the tensor cores and 3.35 TB/s of HBM3.  A card
set below 700 W runs slower under load; the run's device record names the
card, and PERF.md its power limit.
"""

from __future__ import annotations

H100_SXM = {"f32_flops": 67e12, "hbm_bytes": 3.35e12}

#: peaks by ``torch.cuda.get_device_name()``
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def least_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: the larger of the operations at
    the f32 peak and the bytes at the memory peak."""
    return max(ops / peaks["f32_flops"], nbytes / peaks["hbm_bytes"])


def kernel_roofline(r, kernel: str):
    """``kernel``'s share of its roofline in the profiled slice, in %: the
    least time of its launches there (each at the operations and bytes of
    ``app.work``'s count) over their device time; None where the slice
    holds none of them or the card has no row in ``PEAKS``."""
    k = r.work["kernels"].get(kernel)
    if not k or not r.device or not r.peaks:
        return None
    times = [d for name, d in r.device["ops"] if k["match"] in name]
    if not times:
        return None
    least = len(times) * least_seconds(k["ops"], k["bytes"], r.peaks)
    return 100.0 * least / sum(times)
