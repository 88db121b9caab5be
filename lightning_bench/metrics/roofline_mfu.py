"""The whole application's share of the chip's peak, in %: its least time
at the chip's peaks, from the operations and bytes that the problem's
shapes fix (not what implements them), times the applications of the
profiled slice, over the slice's length on the device trace."""

from lightning_bench.harness.peaks import least_seconds


def read(r):
    if not r.peaks or not r.device or not r.device["apps"] \
            or not r.device["window_s"]:
        return None
    ops, nbytes = r.work["app"]
    least = r.device["apps"] * least_seconds(ops, nbytes, r.peaks)
    return 100.0 * least / r.device["window_s"]
