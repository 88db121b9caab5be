"""The profiled slice's reading and the metric readers, on made-up
readings; a reader that finds nothing to read returns None, never 0."""

import pytest

from lightning_bench.harness import bench, peaks, profile
from lightning_bench.harness.session import Readings


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


EVENTS = [
    ev("app", "user_annotation", 0, 100), ev("app", "user_annotation",
                                             100, 100),
    ev("launch:k", "user_annotation", 0, 10),
    ev("launch:k", "user_annotation", 100, 30),
    ev("k_kernel", "kernel", 10, 60), ev("k_kernel", "kernel", 50, 40),
    ev("Memcpy DtoH", "gpu_memcpy", 95, 5), ev("k_kernel", "kernel", 130, 60),
    ev("app", "gpu_user_annotation", 0, 200),
]


def test_slice_reading():
    r = profile.read(EVENTS)
    # busy: [10, 90] + [95, 100] + [130, 190] = 145 us of 200
    assert r["busy_s"] == pytest.approx(145e-6)
    assert r["window_s"] == pytest.approx(200e-6)
    assert r["apps"] == 2
    assert r["device_ops"][0] == ["k_kernel", pytest.approx(160e-6)]
    gaps = dict(r["idle_gaps"])
    # [0, 10) and [100, 130) under launch:k; [90, 95) and [190, 200)
    # under app
    assert gaps["launch:k"] == pytest.approx(40e-6)
    assert gaps["app"] == pytest.approx(15e-6)


def test_empty_slice():
    assert profile.read([])["busy_s"] == 0.0


def readings(**kw):
    base = dict(apps=[0.1, 0.2, 0.3], window_s=0.6, peak_bytes=None,
                setup_end=0.0, spans=[], counters={}, launches=0,
                device=None, work={"app": (0, 0), "kernels": {}},
                peaks=None, checks={}, failed=0, kind="cpu", forbidden=[],
                phases={})
    base.update(kw)
    return Readings(**base)


def read(name, r):
    return bench.metric(name).read(r)


def test_end_to_end_readers():
    r = readings(peak_bytes=2_500_000_000, setup_s=7.5,
                 apps=[0.01 * i for i in range(1, 101)], window_s=50.5)
    assert read("app_ms", r) == pytest.approx(505.0)
    assert read("app_ms_p95", r) == pytest.approx(950.0)
    assert read("peak_device_GB", r) == 2.5
    assert read("setup_s", r) == 7.5


def test_layer_readers_read_nothing_as_none():
    r = readings()
    for name in ("plan_ms", "plan_cache_hit_share", "kmeans_roofline",
                 "hotspot_roofline", "roofline_mfu", "device_idle_share",
                 "halo_bytes_per_launch"):
        assert read(name, r) is None, name


def test_layer_readers():
    dev = {"busy_s": 0.9, "window_s": 1.0, "apps": 3,
           "ops": [("hotspot_kernel(...)", 0.004), ("cat", 0.001),
                   ("hotspot_kernel(...)", 0.004)]}
    work = {"app": (0, 2 * 12 * 2 ** 30),
            "kernels": {"hotspot": {"match": "hotspot_kernel",
                                    "ops": 0, "bytes": 12 * 2 ** 30}}}
    spans = [{"name": "plan:hotspot", "ts": 0, "dur": 0.001, "bytes": None},
             {"name": "plan:hotspot", "ts": 1, "dur": 0.003, "bytes": None},
             {"name": "collective:halo", "ts": 0, "dur": 0.1, "bytes": 512},
             {"name": "collective:halo", "ts": 1, "dur": 0.1, "bytes": 512}]
    r = readings(device=dev, work=work, peaks=peaks.H100_SXM, spans=spans,
                 launches=2, apps=[0.01, 0.01],
                 counters={"plan.cache": 4.0, "plan.cache{result=hit}": 3.0})
    least = 12 * 2 ** 30 / 3.35e12
    assert read("hotspot_roofline", r) == pytest.approx(
        100 * 2 * least / 0.008)
    # the slice's 3 applications of 2 steps each over its 1.0 s on the
    # device trace, whatever the host clock read (apps)
    assert read("roofline_mfu", r) == pytest.approx(100 * 3 * 2 * least)
    assert read("device_idle_share", r) == pytest.approx(10.0)
    assert read("plan_ms", r) == pytest.approx(2.0)
    assert read("plan_cache_hit_share", r) == pytest.approx(75.0)
    assert read("halo_bytes_per_launch", r) == 512.0
    assert read("kmeans_roofline", r) is None
