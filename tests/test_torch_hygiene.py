"""What the port must never do: import JAX or the reference package, build
or launch anything for a CPU tensor, or run on the CPU because no GPU was
found."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels as TK
from repro_torch.core import Context
from repro_torch.core.launch import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.coclustering.kernel import cluster_sums_cuda
from repro_torch.kernels.gemm.kernel import gemm_cuda
from repro_torch.kernels.kmeans.kernel import kmeans_cuda
from repro_torch.kernels.stencil2d.kernel import hotspot_cuda

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

MODULES = ["repro_torch", "repro_torch.core", "repro_torch.kernels",
           "repro_torch.obs", "repro_torch.convert",
           "repro_torch.core.streaming", "repro_torch.examples.quickstart",
           "repro_torch.examples.streaming_kmeans", "chip_smoke"]


@pytest.mark.parametrize("module", MODULES)
def test_import_pulls_in_neither_jax_nor_reference(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) \
        + sorted(PORT.rglob("*.cuh")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    return files


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|"
    r"from\s+repro(\.|\s))", re.MULTILINE)


def test_source_scan_finds_no_forbidden_import():
    hits = [(str(p.relative_to(ROOT)), m.group(0).strip())
            for p in _port_sources()
            for m in FORBIDDEN.finditer(p.read_text())]
    assert hits == []
    # the pattern does catch what it should, and spares the port's own name
    for bad in ("import jax", "from jax import numpy", "import repro",
                "from repro.core import x", "  from repro import core"):
        assert FORBIDDEN.search(bad), bad
    for good in ("import repro_torch", "from repro_torch.core import x"):
        assert not FORBIDDEN.search(good), good


def test_kernels_call_no_library_in_place_of_a_kernel():
    """The launch path of the four kernels holds none of the calls that
    would stand in for a hand-written kernel."""
    stand_ins = re.compile(
        r"torch\.matmul|\bindex_add_?\b|scatter_add|bincount|conv2d|"
        r"torch\.compile|cublas|cudnn|@")
    for sub in ("kmeans", "stencil2d", "coclustering", "gemm"):
        for name in ("kernel.py", "ops.py"):
            text = (PORT / "kernels" / sub / name).read_text()
            code = "\n".join(ln.split("#")[0] for ln in text.splitlines())
            code = re.sub(r'""".*?"""', "", code, flags=re.DOTALL)
            assert not stand_ins.search(code), (sub, name)
    for cu in (PORT / "csrc").glob("*.cu"):
        code = "\n".join(ln for ln in cu.read_text().splitlines()
                         if not ln.lstrip().startswith("//")).lower()
        assert not re.search(r"cublas|cudnn|cutlass/gemm/device", code), cu.name


@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build, load or bind the CUDA library fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the build was touched for a CPU tensor")

    for name in ("build", "load", "bind", "find_nvcc"):
        monkeypatch.setattr(_build, name, refuse)
    counters = (kmeans_cuda, hotspot_cuda, cluster_sums_cuda, gemm_cuda)
    before = [w.launches for w in counters]
    yield
    assert [w.launches for w in counters] == before


def _inputs():
    rng = np.random.RandomState(0)
    f32 = lambda *s: torch.from_numpy(rng.rand(*s).astype(np.float32))
    ints = lambda hi, n: torch.from_numpy(rng.randint(0, hi, n).astype(np.int32))
    return {
        "kmeans": (TK.kmeans_assign_reduce, TK.kmeans_assign_reduce_ref,
                   (f32(300, 4), f32(5, 4)), {}),
        "hotspot": (TK.hotspot_step, TK.hotspot_step_ref,
                    (f32(33, 64) + 70, f32(33, 64)), {}),
        "cluster_sums": (TK.cluster_sums, TK.cluster_sums_ref,
                         (f32(50, 20), ints(4, 50), ints(3, 20), 4, 3), {}),
        "gemm": (TK.gemm, TK.gemm_ref, (f32(20, 30), f32(30, 10)), {}),
    }


@pytest.mark.parametrize("name", ["kmeans", "hotspot", "cluster_sums", "gemm"])
def test_cpu_tensor_takes_plain_version_without_the_build(name, no_build):
    fn, ref, args, kw = _inputs()[name]
    got, want = fn(*args, **kw), ref(*args, **kw)
    if isinstance(want, tuple):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        assert torch.equal(got, want)
    # and use_ref=True names the plain version outright
    again = fn(*args, use_ref=True)
    assert torch.equal(again[0] if isinstance(again, tuple) else again,
                       want[0] if isinstance(want, tuple) else want)


@pytest.mark.parametrize("name,wrapper", [
    ("kmeans", kmeans_cuda), ("hotspot", hotspot_cuda),
    ("cluster_sums", cluster_sums_cuda), ("gemm", gemm_cuda)])
def test_cuda_wrapper_refuses_a_cpu_tensor(name, wrapper, no_build):
    _, _, args, _ = _inputs()[name]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        wrapper(*args)


def test_context_without_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Context()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert Context(device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")


def test_missing_compiler_raises_with_a_reason(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_is_keyed_by_the_sources():
    srcs = _build.sources()
    assert [p.name for p in srcs] == ["cluster_sums.cu", "gemm.cu",
                                      "hotspot.cu", "kmeans.cu"]
    assert _build.build_dir() == ROOT / "build" / "repro_torch"
    d1 = _build._digest(srcs)
    assert d1 == _build._digest(srcs) and len(d1) == 64
    assert _build._digest(srcs[:-1]) != d1
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
