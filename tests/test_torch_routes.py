"""The two-route kernels' route functions, on the CPU.

``gemm_route`` and ``flash_route`` pick a kernel before the launch from
dtype, shape and alignment alone: ``"wgmma"`` (tensor cores fed by TMA)
where TMA can describe the operands, ``"fma"`` (the CUDA cores) for the
rest.  They read only shapes, dtypes and addresses, so CPU tensors stand
in for CUDA ones here; the kernels themselves run on the GPU in
``chip_smoke.py``, which also requires each main-path call to have taken
the route these functions give.
"""

import importlib
import re

import pytest
import torch

from repro_torch.kernels import _build, common

gemm_kernel = importlib.import_module("repro_torch.kernels.gemm.kernel")
flash_kernel = importlib.import_module(
    "repro_torch.kernels.flash_attention.kernel")

bf16, f32 = torch.bfloat16, torch.float32


def _mat(rows, cols, dtype, offset=0):
    """A dense (rows, cols) matrix, ``offset`` elements into its buffer."""
    buf = torch.zeros(offset + rows * cols, dtype=dtype)
    return buf[offset:].view(rows, cols)


@pytest.mark.parametrize("m,k,n", [(8192, 8192, 8192), (200, 136, 264),
                                   (1, 8, 8), (128, 64, 256), (300, 1000, 8)])
def test_gemm_bf16_with_aligned_rows_takes_the_tensor_cores(m, k, n):
    a, b = _mat(m, k, bf16), _mat(k, n, bf16)
    assert gemm_kernel.gemm_route(a, b) == "wgmma"


@pytest.mark.parametrize("what,a,b", [
    ("f32", _mat(128, 64, f32), _mat(64, 256, f32)),
    ("f32 ragged", _mat(100, 60, f32), _mat(60, 130, f32)),
    ("k not a multiple of 8", _mat(100, 60, bf16), _mat(60, 128, bf16)),
    ("n not a multiple of 8", _mat(128, 64, bf16), _mat(64, 130, bf16)),
    ("chip_smoke's ragged case", _mat(100, 60, bf16), _mat(60, 130, bf16)),
    ("a one element in", _mat(64, 64, bf16, offset=1), _mat(64, 64, bf16)),
    ("b one element in", _mat(64, 64, bf16), _mat(64, 64, bf16, offset=1)),
    ("no k", _mat(64, 0, bf16), _mat(0, 64, bf16)),
])
def test_gemm_route_sends_what_tma_cannot_describe_to_fma(what, a, b):
    assert gemm_kernel.gemm_route(a, b) == "fma", what


def _qkv(d, dtype, s=100, t=100, hq=4, hkv=2, offset=0):
    q = torch.zeros(offset + hq * s * d, dtype=dtype)[offset:]
    k = torch.zeros(hkv * t * d, dtype=dtype)
    return (q.view(1, hq, s, d), k.view(1, hkv, t, d),
            k.clone().view(1, hkv, t, d))


@pytest.mark.parametrize("d", [32, 64, 96, 128, 256, 8, 200])
def test_flash_bf16_takes_the_tensor_cores(d):
    assert flash_kernel.flash_route(*_qkv(d, bf16)) == "wgmma"


@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_flash_f32_takes_the_cuda_cores(d):
    assert flash_kernel.flash_route(*_qkv(d, f32)) == "fma"


@pytest.mark.parametrize("what,qkv", [
    ("no keys", _qkv(64, bf16, t=0)),
    ("q one element in", _qkv(64, bf16, offset=1)),
])
def test_flash_route_sends_the_rest_to_fma(what, qkv):
    assert flash_kernel.flash_route(*qkv) == "fma", what


@pytest.mark.parametrize("kernel,fn", [(gemm_kernel, "gemm_cuda"),
                                       (flash_kernel, "flash_attention_cuda")])
def test_two_route_wrappers_count_launches_by_route(kernel, fn):
    wrapper = getattr(kernel, fn)
    assert kernel.ROUTES == ("wgmma", "fma")
    assert set(wrapper.routes) == set(kernel.ROUTES)
    assert all(isinstance(n, int) for n in wrapper.routes.values())


@pytest.mark.parametrize("route,chosen,want", [
    (None, "wgmma", "wgmma"), (None, "fma", "fma"), ("fma", "wgmma", "fma"),
    ("fma", "fma", "fma"), ("wgmma", "wgmma", "wgmma"),
    ("wgmma", "fma", ValueError), ("mma", "wgmma", ValueError),
])
def test_a_named_route_is_taken_only_where_it_can_run(route, chosen, want):
    """The first kernel can always be named (to time it on the same
    inputs); the tensor cores only where the route function chose them."""
    if want is ValueError:
        with pytest.raises(ValueError, match="does not take these inputs"):
            common.resolve_route(route, chosen, "gemm")
    else:
        assert common.resolve_route(route, chosen, "gemm") == want


@pytest.mark.parametrize("err,match", [
    (-1, "refused a TMA tensor map \\(CUresult 1\\)"),
    (700, "CUDA launch failed with error code 700"),
])
def test_a_failed_launch_or_tensor_map_raises(err, match):
    with pytest.raises(RuntimeError, match=match):
        _build.check(err, "gemm (wgmma)")
    _build.check(0, "gemm (wgmma)")


HEADER = _build.CSRC_DIR / "hopper.cuh"


def _wgmma_wrappers():
    """(function, N, source A, register list, trailing operands) of every
    wgmma wrapper written out in hopper.cuh."""
    text = HEADER.read_text()
    found = []
    for m in re.finditer(
            r"void (wgmma_(ss|rs)(\d+))\(.*?m64n(\d+)k16\.f32\.bf16\.bf16 "
            r"\{\"(.*?)\"\}, (.*?);\\n\}\\n\"", text, re.DOTALL):
        regs = re.findall(r"%(\d+)", m.group(5))
        found.append((m.group(1), int(m.group(3)), int(m.group(4)),
                      m.group(2), [int(r) for r in regs], m.group(6)))
    return found


#: the shapes the two kernels issue: the GEMM's m64n256k16 (B MN-major),
#: attention's scores m64n{64,128}k16 and its P V m64n{64,128}k16 (P from
#: registers)
WRAPPERS = ["wgmma_ss64", "wgmma_ss128", "wgmma_ss256", "wgmma_rs64",
            "wgmma_rs128"]


def test_header_writes_out_the_wgmma_shapes_the_kernels_issue():
    assert sorted(f for f, *_ in _wgmma_wrappers()) == sorted(WRAPPERS)


@pytest.mark.parametrize("name", WRAPPERS)
def test_header_wgmma_operands_are_numbered_in_order(name):
    """Each wrapper names its N / 2 accumulator registers %0..%(N/2 - 1) in
    order, and the operands after them by the numbers that follow: a
    misnumbered operand list would still assemble and compute garbage."""
    (_, n, n_inst, src, regs, rest), = [w for w in _wgmma_wrappers()
                                        if w[0] == name]
    assert n == n_inst
    r = n // 2
    assert regs == list(range(r))
    if src == "ss":  # desc_a, desc_b, p (scale_d), trans-b immediate
        assert rest == f"%{r}, %{r + 1}, p, 1, 1, 0, %{r + 3}"
        scale = r + 2
    else:  # A's four registers, desc_b, p (scale_d), B transposed
        assert rest == (f"{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, "
                        "p, 1, 1, 1")
        scale = r + 5
    text = HEADER.read_text()
    body = text[text.index(f"void {name}("):]
    body = body[:body.index("\n}\n")]
    assert f"setp.ne.b32 p, %{scale}, 0;" in body
    assert body.count("HOPPER_D32(") == r // 32


def test_header_edits_rebuild_the_library(tmp_path, monkeypatch):
    """The build's key covers hopper.cuh, so an edit of the header alone
    rebuilds the kernels that include it."""
    for p in _build.CSRC_DIR.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    srcs = _build.sources()
    before = _build._digest(srcs)
    (tmp_path / "hopper.cuh").write_text(HEADER.read_text() + "\n// edit\n")
    assert _build._digest(srcs) != before
