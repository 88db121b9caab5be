"""Every ported module's public names and signatures against the
reference's, on the CPU.

A module of the port (``repro_torch.X``) with a counterpart in the
reference (``repro.X``) must offer each of the reference's public names,
and each function and method must take the reference's parameters in the
reference's order and kind (the reference's ``interpret=`` aside); the port
may append parameters of its own, each with a default.  The deliberate
differences are listed below with their reasons; a listed name the port
does offer fails the test, so the list shrinks as the port grows.

Public names: ``__all__`` where a module has one; otherwise the names not
starting with ``_`` that the module defines, imports from its own
sub-package, or binds to an upper-case constant.
"""

from __future__ import annotations

import __future__
import importlib
import inspect
import os
import pkgutil

import numpy as np
import pytest

import repro.core as R
import repro_torch
import repro_torch.core as T
from repro_torch.convert import work_from_reference

from _torch_parity import task_rows

TPU = "a TPU-only constant or helper of the Pallas kernels"
INCIDENTAL = "imported by the reference module for its own use; public " \
    "where the port defines it"

#: (module without the package prefix, name) -> why the port lacks it
MISSING_OK = {
    ("core.launch", "shard_map"): "JAX's shard_map, which the reference "
                                  "re-exports; the port runs each worker's "
                                  "call itself",
    ("core.launch", "ArrayMeta"): INCIDENTAL,
    ("core.launch", "Region"): INCIDENTAL,
    **{("kernels.common", n): TPU for n in (
        "LANE", "MXU", "PEAK_FLOPS_BF16", "PEAK_HBM_BW", "SUBLANE",
        "VMEM_BYTES", "interpret_default", "vmem_fits")},
    ("kernels.decode_attention.kernel", "NEG_INF"): TPU,
    ("kernels.flash_attention.kernel", "NEG_INF"): TPU,
    ("kernels.md5.kernel", "md5_u32x2"): INCIDENTAL,
    ("utils.roofline", "ICI_BW"): "a TPU's inter-chip link; the port's "
                                  "link is NVLINK_BW",
    ("models.transformer", "apply_rope"): INCIDENTAL,
    ("models.encdec", "layer_norm"): INCIDENTAL,
    ("models.config", "ModelConfig.jdtype"): "the JAX dtype; the port's is "
                                             "ModelConfig.torch_dtype",
    ("models.config", "ModelConfig.unroll_of"): "the JAX scan's unroll "
                                                "factor; the port's layer "
                                                "loop is a Python loop",
}

#: reference parameter -> port parameter, where an initializer (a function
#: whose name holds "init") renames one: a torch.Generator for a JAX key
RENAMED = {"key": "generator"}
#: (module, qualified name) -> why its signature differs
SIGNATURE_OK = {
    **{(m, "collective_reduce"): "takes the list of the workers' "
                                 "partials, where the reference reduces "
                                 "inside shard_map"
       for m in ("core.reductions", "core.launch")},
    **{(m, "init_layer"): "a layer builder inside the model's own "
                          "init_params, which passes the device it resolved"
       for m in ("models.rwkv", "models.transformer")},
    ("core.launch", "Context.synchronize"): "a method: it synchronizes the "
        "context's devices; the reference's is a static method",
    ("utils.hlo_analysis", "collective_stats"): "takes a recording mesh's "
        "records (ranks.recording): the port has no HLO text",
}


def public(module) -> set[str]:
    names = getattr(module, "__all__", None)
    if names is not None:
        return set(names)
    package = module.__name__.rpartition(".")[0] + "."
    out = set()
    for name, value in vars(module).items():
        if name.startswith("_") or inspect.ismodule(value) \
                or isinstance(value, __future__._Feature):
            continue
        if inspect.isclass(value) or inspect.isfunction(value):
            home = value.__module__
            if home == module.__name__ or home.startswith(package):
                out.add(name)
        elif name.isupper():
            out.add(name)
    return out


def members(cls) -> set[str]:
    return {n for n in vars(cls) if not n.startswith("_")}


def port_modules() -> list[str]:
    """The port's modules that have a counterpart in the reference.  The
    environment is kept as it was: the reference's ``launch.dryrun`` sets
    ``XLA_FLAGS`` (512 host devices) when imported, which would reach
    every JAX test that this process runs after it."""
    out = []
    flags = os.environ.get("XLA_FLAGS")
    try:
        for info in pkgutil.walk_packages(repro_torch.__path__,
                                          "repro_torch."):
            rel = info.name[len("repro_torch."):]
            try:
                importlib.import_module(f"repro.{rel}")
            except ModuleNotFoundError:
                continue
            out.append(rel)
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return sorted(out)


MODULES = port_modules()


def signature_problem(ref_fn, port_fn) -> str | None:
    try:
        ref = inspect.signature(ref_fn)
        got = inspect.signature(port_fn)
    except (TypeError, ValueError):
        return None
    renamed = RENAMED if "init" in ref_fn.__name__ else {}
    want = [(renamed.get(p.name, p.name), p.kind)
            for p in ref.parameters.values() if p.name != "interpret"]
    have = [(p.name, p.kind) for p in got.parameters.values()]
    if have[:len(want)] != want:
        return f"{[w[0] for w in want]} -> {[h[0] for h in have]}"
    extra = list(got.parameters.values())[len(want):]
    if any(p.default is inspect.Parameter.empty
           and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
           for p in extra):
        return f"appended parameters without defaults: {extra}"
    return None


def differences(rel: str) -> tuple[set, dict]:
    ref = importlib.import_module(f"repro.{rel}")
    port = importlib.import_module(f"repro_torch.{rel}")
    missing = {n for n in public(ref) - public(port)
               if not n.endswith("_pallas")}
    signatures = {}
    for name in sorted(public(ref) & public(port)):
        a, b = getattr(ref, name), getattr(port, name)
        if inspect.isclass(a) and inspect.isclass(b):
            if a.__module__ != ref.__name__:
                continue  # compared where it is defined
            missing |= {f"{name}.{m}" for m in members(a) - members(b)}
            for m in sorted(members(a) & members(b)):
                fa = inspect.getattr_static(a, m)
                fb = inspect.getattr_static(b, m)
                fa, fb = (getattr(f, "__func__", f) for f in (fa, fb))
                if callable(fa) and callable(fb):
                    problem = signature_problem(fa, fb)
                    if problem:
                        signatures[f"{name}.{m}"] = problem
        elif callable(a) and callable(b):
            problem = signature_problem(a, b)
            if problem:
                signatures[name] = problem
    return missing, signatures


def test_the_comparison_covers_the_port():
    for rel in ("core", "core.memory", "core.scheduler", "obs",
                "obs.overlap", "obs.validate", "dist", "dist.fault",
                "models.config", "models.api", "kernels.rg_lru.ops",
                "optim", "optim.adamw", "optim.schedule",
                "optim.compression", "train", "train.train_loop", "data",
                "data.pipeline", "ckpt", "ckpt.checkpoint", "launch.train",
                "models.layers", "dist.sharding", "dist.collectives",
                "launch.mesh", "launch.rules", "models.attention"):
        assert rel in MODULES, rel


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_and_signatures_match_the_reference(rel):
    missing, signatures = differences(rel)
    allowed = {name for (mod, name) in MISSING_OK if mod == rel}
    assert missing - allowed == set()
    # a listed name the port now offers must leave the list
    assert allowed - missing == set()
    signatures = {n: p for n, p in signatures.items()
                  if (rel, n) not in SIGNATURE_OK}
    assert signatures == {}
    for (mod, name) in SIGNATURE_OK:
        if mod == rel:
            assert name in differences(rel)[1], name


def test_allow_lists_name_ported_modules_only():
    assert {mod for mod, _ in MISSING_OK} <= set(MODULES)
    assert {mod for mod, _ in SIGNATURE_OK} <= set(MODULES)


# ---------------------------------------------------------------------------
# The call shapes those names promise
# ---------------------------------------------------------------------------

STENCIL = "global i => read input[i-1:i+1], write output[i]"


def _stencil(views, info):
    x = views["input"]
    if x.shape[0] == info.grid[0]:
        zero = x.new_zeros(1)
        x = __import__("torch").cat([zero, x, zero])
    return {"output": (x[:-2] + x[1:-1] + x[2:]) / 3.0}


@pytest.mark.parametrize("workers", [1, 2])
def test_context_and_make_array_take_the_mesh_by_position(workers):
    """``Context(mesh)`` and ``make_array(name, value, dist, mesh)``, the
    reference's documented call shapes, on a mesh of CPU workers; the
    launch's plan equals the reference planner's on as many devices."""
    mesh = T.make_mesh((workers,), ("data",), device="cpu")
    ctx = T.Context(mesh)
    assert ctx.mesh is mesh and ctx.device.type == "cpu"
    n = 64
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    a = T.make_array("input", x, T.StencilDist(n // workers, 1), mesh,
                     ("data",))
    b = T.make_array("output", np.zeros(n, np.float32),
                     T.StencilDist(n // workers, 1), mesh, ("data",))
    assert a.mesh is mesh and a.value.device.type == "cpu"
    assert b.mesh_axes == ("data",)
    k = T.KernelDef.define("stencil", _stencil, STENCIL)
    out = ctx.launch(k, grid=(n,), args={"input": a, "output": b},
                     work_dist=T.EvenWork())
    pad = np.pad(x, 1)
    np.testing.assert_allclose(out["output"].to_numpy(),
                               (pad[:-2] + pad[1:-1] + pad[2:]) / 3.0,
                               rtol=1e-6)
    planner = R.Planner(R.Topology(workers, 4))
    arrays = {name: R.ArrayMeta(name, (n,), 4,
                                R.StencilDist(n // workers, 1))
              for name in ("input", "output")}
    want = planner.plan_launch("stencil", R.parse(STENCIL), (n,),
                               R.EvenWork(), arrays)
    assert task_rows(ctx.records[-1].plan.plan) == task_rows(want.plan)
    assert work_from_reference(R.EvenWork()) == T.EvenWork()


def test_reference_context_takes_the_mesh_by_position_too():
    import jax

    mesh = jax.make_mesh((1,), ("data",))
    ctx = R.Context(mesh)
    arr = R.make_array("x", np.ones(4, np.float32), R.RowDist(), mesh)
    assert ctx.mesh is mesh and arr.mesh is mesh


def test_device_and_workers_are_keyword_only():
    with pytest.raises(TypeError):
        T.make_array("x", np.ones(4, np.float32), T.RowDist(), None, (),
                     "cpu")
    params = inspect.signature(T.Context).parameters
    for name in ("device", "num_workers"):
        assert params[name].kind is inspect.Parameter.KEYWORD_ONLY
    arr = T.make_array("x", np.ones(4, np.float32), T.RowDist(),
                       device="cpu")
    assert arr.value.device.type == "cpu" and arr.mesh is None


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b",
                                  "phi3-mini-3.8b", "gemma-2b"])
def test_model_config_properties_match_the_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.models.api import model_flops_per_token as ref_flops
    from repro_torch.configs import get_config
    from repro_torch.models.api import model_flops_per_token

    cfg, ref = get_config(arch), ref_config(arch)
    assert cfg.is_attention_free == ref.is_attention_free
    assert cfg.supports_long_context == ref.supports_long_context
    assert model_flops_per_token(cfg) == ref_flops(ref)
    assert model_flops_per_token(cfg, 10) == ref_flops(ref, 10) == 60.0
    if arch == "rwkv6-3b":
        assert cfg.is_attention_free and cfg.supports_long_context
    if arch == "phi3-mini-3.8b":
        assert model_flops_per_token(cfg) == pytest.approx(2.2925e10,
                                                           rel=1e-4)


def test_constrain_and_rg_lru_ref_names():
    from repro_torch.dist import constrain
    from repro_torch.kernels.rg_lru.ops import rg_lru_ref
    from repro_torch.kernels.rg_lru.ref import rg_lru_ref as ref_fn

    x = object()
    assert constrain(x, None, logical_axes=("batch", None)) is x
    assert rg_lru_ref is ref_fn


def test_the_tensor_parallel_names_and_their_module():
    """``dist.tensor_parallel`` is the port's own module (the reference has
    GSPMD in its place, so no counterpart is compared): the dist package
    exports its operators (and no family check: every family has
    tensor-parallel layers), and the names the reference's modules gained a
    counterpart for here take the reference's parameters first
    (``init_params``, ``init_decode_state``, ``params_from_reference``
    append ``rules``)."""
    import repro_torch.dist as D
    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.models import api

    assert "dist.tensor_parallel" not in MODULES
    names = {"copy_to_model", "reduce_from_model", "gather_from_model",
             "vocab_parallel_embed", "vocab_parallel_xent"}
    assert names <= set(D.__all__)
    assert not hasattr(D, "check_tp_family")
    for name in names:
        assert getattr(D, name) is getattr(TP, name)
    for fn in (api.init_params, api.init_decode_state):
        params = inspect.signature(fn).parameters
        assert list(params)[-1] == "rules"
        assert params["rules"].default is None
    assert "param_shapes" in public(api)

