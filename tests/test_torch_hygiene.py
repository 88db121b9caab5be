"""What the port must never do: import JAX or the reference package, build
or launch anything for a CPU tensor, or run on the CPU because no GPU was
found."""

import importlib
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
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, common
from repro_torch.kernels.black_scholes.kernel import black_scholes_cuda
from repro_torch.kernels.coclustering.kernel import cluster_sums_cuda
from repro_torch.kernels.correlator.kernel import correlate_cuda
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.gemm.kernel import gemm_cuda
from repro_torch.kernels.kmeans.kernel import kmeans_cuda
from repro_torch.kernels.md5.kernel import md5_search_cuda
from repro_torch.kernels.nbody.kernel import nbody_cuda
from repro_torch.kernels.rg_lru.kernel import rg_lru_cuda
from repro_torch.kernels.rwkv6.kernel import wkv6_cuda
from repro_torch.kernels.spmv_ell.kernel import spmv_ell_cuda
from repro_torch.kernels.stencil2d.kernel import hotspot_cuda

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

MODULES = ["repro_torch", "repro_torch.device", "repro_torch.core",
           "repro_torch.kernels", "repro_torch.kernels.md5", "repro_torch.obs",
           "repro_torch.convert",
           "repro_torch.core.streaming", "repro_torch.core.mesh",
           "repro_torch.examples.quickstart",
           "repro_torch.examples.streaming_kmeans", "repro_torch.models",
           "repro_torch.serve.engine", "repro_torch.launch.serve",
           "repro_torch.configs", "repro_torch.examples.serve_lm",
           "repro_torch.kernels.correlator", "repro_torch.kernels.rwkv6",
           "repro_torch.kernels.rg_lru", "repro_torch.models.rwkv",
           "repro_torch.models.rglru", "repro_torch.core.memory",
           "repro_torch.core.scheduler", "repro_torch.obs.overlap",
           "repro_torch.obs.validate", "repro_torch.dist",
           "repro_torch.dist.fault", "repro_torch.optim",
           "repro_torch.train", "repro_torch.data", "repro_torch.ckpt",
           "repro_torch.launch.train", "repro_torch.examples.train_lm",
           "repro_torch.dist.sharding", "repro_torch.dist.ranks",
           "repro_torch.dist.collectives", "repro_torch.launch.mesh",
           "repro_torch.launch.rules", "repro_torch.dist.tensor_parallel",
           "chip_smoke"]


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
        + sorted(PORT.rglob("*.cuh")) + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "tools").glob("*.py"))
    assert len(files) > 30
    return files


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|"
    r"from\s+repro(\.|\s))", re.MULTILINE)


def test_source_scan_covers_the_shared_hopper_header():
    """The tensor-core kernels' shared header is scanned like the kernels."""
    assert PORT / "csrc" / "hopper.cuh" in _port_sources()


def test_source_scan_covers_the_runtime_model():
    """The memory manager, simulator, overlap analyzer, trace validator and
    fault layer are scanned like the rest of the port."""
    for rel in ("core/memory.py", "core/scheduler.py", "obs/overlap.py",
                "obs/validate.py", "dist/fault.py"):
        assert PORT / rel in _port_sources(), rel


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


def test_kernels_do_not_import_the_launch_layer():
    """``core`` builds on ``kernels``; a kernel module that imported
    ``core`` back would make a cycle."""
    upward = re.compile(r"^\s*(from\s+(\.\.\.?core\b|repro_torch\.core\b)|"
                        r"import\s+repro_torch\.core\b)", re.MULTILINE)
    for bad in ("from ...core.launch import x", "from repro_torch.core import y",
                "import repro_torch.core.launch"):
        assert upward.search(bad), bad
    hits = [str(p.relative_to(ROOT))
            for p in sorted((PORT / "kernels").rglob("*.py"))
            if upward.search(p.read_text())]
    assert hits == []


def test_stride_grid_covers_the_items_up_to_eight_blocks_an_sm(monkeypatch):
    monkeypatch.setattr(common, "sm_count", lambda index: 132)
    dev = torch.device("cuda", 0)
    assert common.stride_grid(1, dev) == 1
    assert common.stride_grid(257, dev) == 2
    assert common.stride_grid(2**30, dev) == 8 * 132


#: the ported kernels' subpackages
PORTED = ("kmeans", "stencil2d", "coclustering", "gemm", "black_scholes",
          "spmv_ell", "md5", "nbody", "flash_attention", "decode_attention",
          "correlator", "rwkv6", "rg_lru")


def test_kernels_call_no_library_in_place_of_a_kernel():
    """The launch path of the ported kernels holds none of the calls that
    would stand in for a hand-written kernel."""
    stand_ins = re.compile(
        r"torch\.matmul|\bindex_add_?\b|scatter_add|bincount|conv2d|"
        r"torch\.compile|torch\.sparse|torch\.special|cublas|cudnn|@|"
        r"scaled_dot_product_attention")
    for bad in ("torch.sparse.mm(a, x)", "torch.sparse_csr_tensor(",
                "torch.special.ndtr(d)",
                "F.scaled_dot_product_attention(q, k, v)"):
        assert stand_ins.search(bad), bad
    for sub in PORTED:
        for name in ("kernel.py", "ops.py"):
            text = (PORT / "kernels" / sub / name).read_text()
            code = "\n".join(ln.split("#")[0] for ln in text.splitlines())
            code = re.sub(r'""".*?"""', "", code, flags=re.DOTALL)
            assert not stand_ins.search(code), (sub, name)
    sources = sorted((PORT / "csrc").glob("*.cu")) \
        + sorted((PORT / "csrc").glob("*.cuh"))
    assert PORT / "csrc" / "hopper.cuh" in sources
    for cu in sources:
        code = "\n".join(ln for ln in cu.read_text().splitlines()
                         if not ln.lstrip().startswith("//")).lower()
        assert not re.search(r"cublas|cudnn|cutlass/gemm/device|"
                             r"cutlass/gemm/kernel|collective", code), cu.name


def test_the_port_never_calls_the_library_attention():
    """PyTorch's fused attention stands nowhere in the port (chip_smoke.py
    may time it beside the kernels as a yardstick, and nothing else)."""
    hits = [str(p.relative_to(ROOT)) for p in sorted(PORT.rglob("*.py"))
            if "scaled_dot_product_attention" in p.read_text()]
    assert hits == []


@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build, load or bind the CUDA library fails the test."""
    def refuse(*a, **k):
        raise AssertionError("the build was touched for a CPU tensor")

    for name in ("build", "load", "bind", "find_nvcc"):
        monkeypatch.setattr(_build, name, refuse)
    counters = (kmeans_cuda, hotspot_cuda, cluster_sums_cuda, gemm_cuda,
                black_scholes_cuda, spmv_ell_cuda, md5_search_cuda, nbody_cuda,
                flash_attention_cuda, decode_attention_cuda, correlate_cuda,
                wkv6_cuda, rg_lru_cuda)
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
        "black_scholes": (TK.black_scholes, TK.black_scholes_ref,
                          (f32(50) + 5, f32(50) + 1, f32(50) + 0.25), {}),
        "spmv_ell": (TK.spmv_ell, TK.spmv_ell_ref,
                     (f32(40, 8), ints(40, (40, 8)), f32(40)), {}),
        "md5": (TK.md5_search, TK.md5_search_ref, (300, (1, 2, 3, 4)),
                {"device": "cpu"}),
        "nbody": (TK.nbody_forces, TK.nbody_forces_ref, (f32(70, 4),), {}),
        "flash_attention": (TK.flash_attention, TK.attention_ref,
                            (f32(1, 4, 20, 16), f32(1, 2, 20, 16),
                             f32(1, 2, 20, 16)), {}),
        "decode_attention": (TK.decode_attention, TK.decode_attention_ref,
                             (f32(2, 4, 16), f32(2, 2, 30, 16),
                              f32(2, 2, 30, 16)),
                             {"kv_len": torch.tensor([7, 30],
                                                     dtype=torch.int32)}),
        "correlate": (TK.correlate, TK.correlate_ref, (f32(3, 20, 5, 2),),
                      {}),
        "wkv6": (TK.wkv6, TK.wkv6_ref,
                 (f32(2, 3, 9, 8), f32(2, 3, 9, 8), f32(2, 3, 9, 4),
                  f32(2, 3, 9, 8), f32(3, 8), f32(2, 3, 8, 4)), {}),
        "rg_lru": (TK.rg_lru, TK.rg_lru_ref,
                   (-f32(2, 9, 20), f32(2, 9, 20), f32(2, 20)), {}),
    }


NAMES = ["kmeans", "hotspot", "cluster_sums", "gemm", "black_scholes",
         "spmv_ell", "md5", "nbody", "flash_attention", "decode_attention",
         "correlate", "wkv6", "rg_lru"]


@pytest.mark.parametrize("name", NAMES)
def test_cpu_tensor_takes_plain_version_without_the_build(name, no_build):
    fn, ref, args, kw = _inputs()[name]
    got, want = fn(*args, **kw), ref(*args, **kw)
    if isinstance(want, tuple):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        assert torch.equal(got, want)
    # and use_ref=True names the plain version outright
    again = fn(*args, use_ref=True, **kw)
    assert torch.equal(again[0] if isinstance(again, tuple) else again,
                       want[0] if isinstance(want, tuple) else want)


@pytest.mark.parametrize("name,wrapper", [
    ("kmeans", kmeans_cuda), ("hotspot", hotspot_cuda),
    ("cluster_sums", cluster_sums_cuda), ("gemm", gemm_cuda),
    ("black_scholes", black_scholes_cuda), ("spmv_ell", spmv_ell_cuda),
    ("nbody", nbody_cuda), ("flash_attention", flash_attention_cuda),
    ("decode_attention", decode_attention_cuda),
    ("correlate", correlate_cuda), ("wkv6", wkv6_cuda),
    ("rg_lru", rg_lru_cuda)])
def test_cuda_wrapper_refuses_a_cpu_tensor(name, wrapper, no_build):
    _, _, args, kw = _inputs()[name]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        wrapper(*args, *kw.values())


def test_cuda_check_refuses_a_tensor_that_requires_grad(monkeypatch,
                                                        no_build):
    """The kernels have no backward: every launcher's check refuses an
    input that autograd would carry a gradient through (here on CPU
    tensors taken for CUDA ones), and takes it under ``torch.no_grad`` or
    detached.  The refusal comes before any build or launch."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    q = torch.zeros((1, 2, 8, 16), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        common.check_cuda_tensor("q", q, (torch.float32,), 4)
    with torch.no_grad():
        common.check_cuda_tensor("q", q, (torch.float32,), 4)
    common.check_cuda_tensor("q", q.detach(), (torch.float32,), 4)
    kv = torch.zeros((1, 1, 8, 16))
    with pytest.raises(RuntimeError, match="q: requires a gradient"):
        flash_attention_cuda(q, kv, kv)
    with pytest.raises(RuntimeError, match="k: requires a gradient"):
        flash_attention_cuda(q.detach(), kv.requires_grad_(), kv)


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-3b",
                                  "recurrentgemma-2b",
                                  "granite-moe-1b-a400m", "whisper-medium"])
def test_serving_never_hands_a_kernel_a_tensor_that_requires_grad(
        monkeypatch, arch):
    """Serving runs its forward passes under ``torch.no_grad``, so the
    guard above never fires there, even on parameters that require a
    gradient (a train state's): every kernel wrapper the models call is
    spied on, on CPU tensors, for what ``check_cuda_tensor`` would see."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api, attention, rglru, rwkv

    seen = []

    def spy(fn):
        def call(*args, **kw):
            tensors = [a for a in list(args) + list(kw.values())
                       if isinstance(a, torch.Tensor)]
            seen.append(torch.is_grad_enabled()
                        and any(t.requires_grad for t in tensors))
            return fn(*args, **kw)
        return call

    for module, name in ((attention, "flash_attention"),
                         (attention, "cuda_decode"), (rwkv, "wkv6"),
                         (rglru, "rg_lru")):
        monkeypatch.setattr(module, name, spy(getattr(module, name)))
    cfg = get_smoke_config(arch)
    params = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params.requires_grad_(True)
    state = api.init_decode_state(cfg, 2, 16, "cpu")
    batch = {"tokens": torch.zeros((2, 5), dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((2, cfg.enc_frames, cfg.d_model))
    _, state = api.prefill(params, batch, cfg, state)
    api.decode_step(params, batch["tokens"][:, :1], cfg, state)
    assert seen and not any(seen)


def test_md5_wrapper_refuses_the_cpu(no_build):
    """The MD5 search takes no tensor: its wrapper refuses a CPU device."""
    with pytest.raises(ValueError, match="expected a CUDA device"):
        md5_search_cuda(300, (1, 2, 3, 4), "cpu")


def test_md5_search_without_cuda_raises_instead_of_running_on_cpu(
        monkeypatch, no_build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for search in (TK.md5_search,
                   lambda n, t: TK.md5_search(n, t, use_ref=True),
                   TK.md5_search_ref):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            search(300, (1, 2, 3, 4))
    assert int(TK.md5_search(300, (1, 2, 3, 4), device="cpu")) == 300


def test_context_without_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Context()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert Context(device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")


def test_serving_without_cuda_raises_instead_of_running_on_cpu(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import run_serving
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("phi3-mini-3.8b")
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, cfg, slots=1, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serving("phi3-mini-3.8b", requests=1, max_new=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(torch.Generator().manual_seed(0), cfg)
    assert ServeEngine(params, cfg, slots=1, max_len=8,
                       device="cpu").device == torch.device("cpu")


def test_cpu_serving_path_never_touches_the_build(no_build):
    """The model's default attention_impl is "cuda": on CPU tensors every
    layer's prefill and decode take the plain versions, without a build."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api

    cfg = get_smoke_config("gemma-2b")
    assert cfg.attention_impl == "cuda"
    params = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = api.init_decode_state(cfg, 2, 16, "cpu")
    toks = torch.zeros((2, 5), dtype=torch.int32)
    logits, state = api.prefill(params, {"tokens": toks}, cfg, state)
    logits, state = api.decode_step(params, toks[:, :1], cfg, state)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
def test_cpu_recurrent_serving_path_never_touches_the_build(arch, no_build):
    """The recurrent families' scans (and the hybrid's prefill attention)
    take the plain versions on CPU tensors, without a build."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api

    cfg = get_smoke_config(arch)
    assert cfg.attention_impl == "cuda"
    params = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = api.init_decode_state(cfg, 2, 16, "cpu")
    toks = torch.zeros((2, 5), dtype=torch.int32)
    logits, state = api.prefill(params, {"tokens": toks}, cfg, state)
    logits, state = api.decode_step(params, toks[:, :1], cfg, state)
    assert torch.isfinite(logits).all()


def test_missing_compiler_raises_with_a_reason(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_is_keyed_by_the_sources():
    srcs = _build.sources()
    assert [p.name for p in srcs] == [
        "black_scholes.cu", "cluster_sums.cu", "correlator.cu",
        "decode_attention.cu", "decode_attention_int8.cu",
        "decode_attention_int8_gemv.cu", "flash_attention.cu", "gemm.cu", "hotspot.cu",
        "kmeans.cu", "md5.cu", "nbody.cu", "rg_lru.cu", "spmv_ell.cu",
        "wkv6.cu"]
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


def test_chip_smoke_counts_sass_opcodes_per_kernel(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    text = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _ZN37_GLOBAL__N__e51410c_6_md5_cu_f5ec055b17md5_search_"
        "kernelEjjjjjPi",
        '\t.headerflags\t@"EF_CUDA_SM90"',
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
        "     /* 0x00000a00ff017b82 */",
        "                                                   "
        "     /* 0x000fe20000000800 */",
        "        /*0010*/                   LOP3.LUT R2, R3, R4, R5, 0x96, !PT ;",
        "        /*0020*/               @P0 EXIT ;",
        "        /*0030*/              @!P0 BRA 0x120;",
        "\t\tFunction : _ZN12_GLOBAL__N_115spmv_ell_kernelILb1EEEvPKfPKiS2_Pfxiii",
        "        /*0000*/                   IADD3 R1, R2, R3, R4 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_115spmv_ell_kernelILb0EEEvPKfPKiS2_Pfxiii",
        "        /*0000*/                   IADD3 R1, R2, R3, R4 ;",
        "        /*0010*/                   SHF.L.W.U32.HI R1, R1, 0x7, R1 ;",
    ])
    assert smoke.sass_opcode_counts(text) == {
        "md5_search_kernel": {"total": 4, "BRA": 1, "EXIT": 1, "LDC": 1,
                              "LOP3": 1},
        "spmv_ell_kernel": {"total": 1, "IADD3": 1},
        "spmv_ell_kernel#1": {"total": 2, "IADD3": 1, "SHF": 1},
    }
    assert smoke.demangled_name("_Z11gemm_kernelPKfS0_Pfiii") == "gemm_kernel"
    assert smoke.demangled_name("main") == "main"


def test_chip_smoke_counts_slots_a_pair_in_the_innermost_rsqrt_loop(
        monkeypatch):
    """``loop_slots`` finds the smallest loop (a backward branch's target
    to the branch) that holds a MUFU and counts its issue slots a pair;
    the outer loop, with the tile load and the barrier, is not it."""
    monkeypatch.syspath_prepend(str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    name = "_ZN12_GLOBAL__N_117nbody_tile_kernelILi2ELb0EEEvPK6float4Pfifi"
    text = "\n".join([
        f"\t\tFunction : {name}",
        "        /*0000*/                   LDG.E.128 R4, desc[UR4][R2.64] ;",
        "        /*0010*/                   STS.128 [R0], R4 ;",
        "        /*0020*/                   LDS.128 R8, [R1] ;",
        "        /*0030*/                   FADD R12, R8, -R20 ;",
        "        /*0040*/                   FADD R13, R8, -R21 ;",
        "        /*0050*/                   FFMA R14, R12, R12, R22 ;",
        "        /*0060*/                   MUFU.RSQ R15, R14 ;",
        "        /*0070*/                   MUFU.RSQ R16, R14 ;",
        "        /*0080*/                   FMUL R17, R15, R15 ;",
        "        /*0090*/                   IADD3 R1, R1, 0x10, RZ ;",
        "        /*00a0*/              @P0 BRA 0x20;",
        "        /*00b0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;",
        "        /*00c0*/              @P1 BRA 0x0;",
        "        /*00d0*/                   EXIT ;",
        "\t\tFunction : _ZN12_GLOBAL__N_112md5_kernelEv",
        "        /*0000*/                   MUFU.RSQ R1, R1 ;",
        "        /*0010*/              @P1 BRA 0x0;",
    ])
    got = smoke.loop_slots(text, "nbody_tile_kernel")
    assert list(got) == [name]
    assert got[name] == {
        "pairs": 2, "slots": 9, "fp32": 4, "mufu": 2, "lds": 1, "other": 2,
        "fsetp": 0, "slots_per_pair": 4.5, "fp32_per_pair": 2.0,
        "lds_per_pair": 0.5}
    with pytest.raises(AssertionError, match="no loop with a MUFU"):
        smoke.loop_slots(text.replace("MUFU.RSQ", "FMUL"),
                         "nbody_tile_kernel")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "whisper-medium"])
def test_cpu_serving_of_the_moe_and_whisper_families_never_touches_the_build(
        no_build, arch):
    """As above for the MoE family's routed layers and Whisper's encoder,
    decoder prefill and two decode attentions a layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api

    cfg = get_smoke_config(arch)
    params = api.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = api.init_decode_state(cfg, 2, 16, "cpu")
    batch = {"tokens": torch.zeros((2, 5), dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((2, cfg.enc_frames, cfg.d_model))
    logits, state = api.prefill(params, batch, cfg, state)
    logits, state = api.decode_step(params, batch["tokens"][:, :1], cfg,
                                    state)
    assert torch.isfinite(logits).all()
