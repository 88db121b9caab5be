"""Meshes of ranks.

A mesh here is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
process group this process has joined (``repro_torch.dist.ranks.spawn``
starts them): the reference's ``jax.make_mesh`` over devices.  It is built
on the group's backend: its device type is ``"cuda"`` under NCCL and
``"cpu"`` under gloo, which stages a card's tensors through the host.  The
production mesh of 256 or 512 ranks (``make_production_mesh``) is its
geometry alone, which the dry run (``repro_torch.launch.dryrun``) records
collectives over.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.dist.ranks import mesh_sizes, set_mesh


def make_production_mesh(*, multi_pod: bool = False) -> dict[str, int]:
    """The assigned production mesh's geometry as an {axis: size} mapping:
    one pod is (16, 16) = 256 chips with axes (data, model), two pods
    (2, 16, 16) = 512 chips with axes (pod, data, model).  A mapping, not
    a ``DeviceMesh``: 256 or 512 processes cannot be spawned on one
    machine.  ``rules_for``, ``ranks.mesh_sizes`` and ``ranks.recording``
    take it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` with ``axes`` over the initialized
    group (its size the product of ``shape``), made the current mesh of
    :mod:`repro_torch.dist.ranks`.  Every rank calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(repro_torch.dist.ranks.spawn starts one)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))
    set_mesh(mesh)
    return mesh


def data_axes_of(mesh) -> tuple[str, ...]:
    """Axes used for data parallelism: everything except 'model'.
    ``mesh`` may be a ``DeviceMesh`` or an {axis: size} mapping."""
    return tuple(a for a in mesh_sizes(mesh) if a != "model")


def parse_mesh(text: str | None) -> tuple[int, int] | None:
    """``"1,4"`` as (1, 4); None passes through."""
    if text is None:
        return None
    data, model = (int(x) for x in text.split(","))
    return data, model


def spawn_backend(device, world: int) -> tuple[str | None, str | None]:
    """The backend and device of ``world`` ranks: gloo on the CPU where
    ``device`` is the CPU; NCCL, one card a rank, where there are as many
    cards; else gloo with every rank on the first card (NCCL refuses two
    ranks on one card)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo", "cpu"
    resolve_device(device)  # raises where there is no card
    if torch.cuda.device_count() >= world:
        return None, None
    return "gloo", "cuda:0"
