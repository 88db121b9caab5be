"""State carried across from the reference package.

The launch path's state is arrays with distributions, and launch
descriptions; the serving path's is a model config and its parameters; the
training path's is those parameters with the optimizer's state.
This module turns the reference package's objects, handed over as numpy
arrays and plain Python values, into this package's, without importing the
reference: a ``Distribution``, ``WorkDistribution`` or ``ModelConfig``
instance is mapped to the class of the same name here by
``type(obj).__name__`` and its dataclass fields, and a parameter tree of
float32 numpy arrays becomes the port's module.  The parity tests build
every input with numpy from a seed and hand it to both sides through this
one door.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .core import distributions as _dists
from .core import superblock as _work
from .core.dist_array import DistributedArray
from .core.distributions import Distribution
from .core.superblock import WorkDistribution
from .device import resolve_device
from .models import rglru, rwkv
from .models.api import local_params
from .models.config import ModelConfig
from .models.encdec import EncDec
from .models.rglru import Griffin
from .models.rwkv import RWKV
from .models.transformer import Transformer
from .optim.adamw import AdamWState
from .train.train_loop import TrainState


def _same_named(obj: Any, module, base: type) -> Any:
    if isinstance(obj, base):  # already one of ours
        return obj
    name = type(obj).__name__
    cls = getattr(module, name, None)
    if not (isinstance(cls, type) and issubclass(cls, base)):
        raise TypeError(
            f"no {base.__name__} named {name!r} in {module.__name__}")
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"{name} is not a dataclass instance")
    # Field by field, not asdict(): asdict would recurse into nested
    # dataclasses and copy callables' containers.
    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return cls(**fields)


def dist_from_reference(obj: Any) -> Distribution:
    """A reference ``Distribution`` as this package's class of that name.
    ``CustomDist`` carries its callables over as they are; they must
    return this package's ``Chunk``/``Region`` to be usable here."""
    return _same_named(obj, _dists, Distribution)


def work_from_reference(obj: Any) -> WorkDistribution:
    """A reference ``WorkDistribution`` as this package's class of that
    name."""
    return _same_named(obj, _work, WorkDistribution)


def array_from_reference(ctx, name: str, np_value: np.ndarray,
                         dist: Any = None) -> DistributedArray:
    """A reference array, handed over as ``np.asarray(arr.value)`` with its
    name and distribution, as a ``DistributedArray`` on ``ctx``'s device."""
    value = np.ascontiguousarray(np_value)
    return ctx.array(value, dist=None if dist is None
                     else dist_from_reference(dist), name=name)


#: the reference's ``attention_impl`` values, as this package names them
_ATTENTION_IMPL = {"pallas": "cuda", "xla": "xla", "naive": "naive"}


def config_from_reference(ref_cfg: Any) -> ModelConfig:
    """A reference ``ModelConfig`` as this package's: every field kept,
    ``attention_impl="pallas"`` (the TPU kernels) becomes ``"cuda"``."""
    if type(ref_cfg).__name__ != "ModelConfig" or not \
            dataclasses.is_dataclass(ref_cfg):
        raise TypeError(f"not a ModelConfig: {type(ref_cfg).__name__}")
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ref_cfg)}
    fields["attention_impl"] = _ATTENTION_IMPL[fields["attention_impl"]]
    return ModelConfig(**fields)


def params_from_reference(np_tree: dict, cfg: ModelConfig,
                          device: torch.device | str | None = None,
                          rules=None
                          ) -> Transformer | RWKV | Griffin | EncDec:
    """The reference's parameter tree, handed over as float32 numpy arrays
    (``jax.tree.map(lambda a: np.asarray(a, np.float32), params)``), as
    this package's module holding the same numbers on ``device`` (None: the
    GPU), in ``cfg``'s dtype except for the leaves the reference creates in
    f32 whatever the config says (RWKV's ``bonus``, the hybrid's
    ``log_lambda``).  Dense, VLM, MoE and RWKV trees have their layers
    stacked on axis 0, the encoder-decoder's ``enc_layers`` and
    ``dec_layers`` likewise; the hybrid's has its (rec, rec, attn) groups
    stacked and its tail as a list of blocks.  With ``rules`` on a mesh of
    ranks, this rank's slice of each leaf they split
    (``models.api.local_params``)."""
    if rules is not None:
        return local_params(params_from_reference(np_tree, cfg, device),
                            cfg, rules)
    device = resolve_device(device)
    keep_f32 = {"rwkv": rwkv.FLOAT32_PARAMS,
                "hybrid": rglru.FLOAT32_PARAMS}.get(cfg.family, ())

    def tensor(a, name=None):
        dtype = torch.float32 if name in keep_f32 else cfg.torch_dtype
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    def whole(tree):
        return {k: whole(v) if isinstance(v, dict) else tensor(v, k)
                for k, v in tree.items()}

    def entry(tree, i):  # entry i of a tree stacked on axis 0
        return {k: entry(v, i) if isinstance(v, dict) else tensor(v[i], k)
                for k, v in tree.items()}

    def count(stacked, want, what):
        leaf = stacked
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        n = len(leaf)
        if n != want:
            raise ValueError(f"{n} {what} in the tree, {want} in cfg")
        return n

    if cfg.family == "encdec":
        enc, dec = np_tree["enc_layers"], np_tree["dec_layers"]
        return EncDec(
            tensor(np_tree["embed"]), tensor(np_tree["dec_pos"]),
            [entry(enc, i) for i in range(count(enc, cfg.n_enc_layers,
                                                "encoder layers"))],
            whole(np_tree["enc_norm"]),
            [entry(dec, i) for i in range(count(dec, cfg.n_layers,
                                                "decoder layers"))],
            whole(np_tree["dec_norm"]))
    embed, final = tensor(np_tree["embed"]), whole(np_tree["final_norm"])
    if cfg.family == "hybrid":
        g, tail = rglru.n_groups(cfg)
        groups = np_tree["groups"]
        count(groups["rec1"], g, "groups")
        if len(np_tree["tail"]) != tail:
            raise ValueError(f"{len(np_tree['tail'])} tail blocks in the "
                             f"tree, {tail} in cfg")
        return Griffin(embed, [entry(groups, i) for i in range(g)],
                       [whole(t) for t in np_tree["tail"]], final)
    stacked = np_tree["layers"]
    n = count(stacked, cfg.n_layers, "layers")
    layers = [entry(stacked, i) for i in range(n)]
    if cfg.family == "rwkv":
        return RWKV(embed, layers, final, tensor(np_tree["lm_head"]))
    head = np_tree.get("lm_head")
    return Transformer(embed, layers, final,
                       None if head is None else tensor(head))


def train_state_from_reference(np_state: Any, cfg: ModelConfig,
                               device: torch.device | str | None = None
                               ) -> TrainState:
    """The reference's ``TrainState``, handed over with numpy leaves
    (``jax.tree.map(np.asarray, state)``), as this package's on ``device``
    (None: the GPU): the params as ``params_from_reference`` makes them,
    with gradients on, and the f32 master and moments keyed by the params'
    names, each tree carried through the same name mapping."""
    device = resolve_device(device)
    params = params_from_reference(np_state.params, cfg, device)
    params.requires_grad_(True)
    f32 = dataclasses.replace(cfg, dtype="float32")

    def named_f32(tree):
        module = params_from_reference(tree, f32, device)
        return {name: p.detach() for name, p in module.named_parameters()}

    opt = np_state.opt
    return TrainState(params=params, opt=AdamWState(
        step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                          device=device),
        master=named_f32(opt.master), mu=named_f32(opt.mu),
        nu=named_f32(opt.nu)))


def spec_from_reference(spec: Any) -> tuple | None:
    """The reference's ``PartitionSpec`` (or any sequence of entries) as
    this package's partition spec, a plain tuple: ``P('data', None)`` is
    ``('data', None)``, ``P()`` is ``()``, a tuple entry stays a tuple;
    None passes through."""
    if spec is None:
        return None
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)
