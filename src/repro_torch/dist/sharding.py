"""Logical-axis sharding rules and the planner -> partition-spec bridge.

A :class:`ShardingRules` maps *logical* array axes (``batch``, ``seq``,
``heads``, ``d_ff``, ...) to mesh axes of the production ``("pod", "data",
"model")`` mesh.  Model code never names mesh axes: every weight and
activation carries a tuple of logical axis names, and the rules turn that
tuple into a partition spec (``.spec``), a whole tree of them
(:func:`tree_specs`), or a constraint (:func:`constrain`).  A partition spec
is a plain tuple, one entry an array axis: ``None``, a mesh axis, or a
tuple of mesh axes (the reference's ``P('data', None)`` is
``('data', None)``, ``P()`` is ``()``).

Two presets:

* :func:`dp_rules`: the Lightning-faithful baseline; the batch axis is
  superblock-sharded over every mesh axis, weights are replicated.
* :func:`tp_rules`: Megatron-style placement; batch over the data axes,
  head, ffn, vocab and expert dims over ``model``, the optimizer state
  ZeRO-1 sharded over the data axes through the ``zero1`` logical axis.

:func:`derive_rules_from_plan` is the planner bridge: an array dimension
indexed by a *point* expression on a grid variable can be sharded along
that grid axis' mesh axis, while slice and halo accesses force
replication, as the planner's gather and halo lowering do.

The mesh a rule table carries is a ``torch.distributed`` ``DeviceMesh`` of
ranks (``repro_torch.launch.mesh.make_mesh``).  Each rank holds its own part
of every array already: the train step splits the batch by rank, and on a
``"model"`` axis of more than one rank the tensor-parallel layers
(:mod:`repro_torch.dist.tensor_parallel`) of every family hold their slice
of every split weight and activation, with the collectives where GSPMD
would put them.  So a constraint moves nothing; it checks that a split
dimension is the rank's share.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from repro_torch.core.annotations import Annotation, parse

from .ranks import axis_index, mesh_sizes, psum_grad, use_mesh

# A rule value: None (replicated), one mesh axis, or a tuple of mesh axes.
Axes = Any

# Default mesh-axis names of the production pod mesh.
MESH_AXES = ("pod", "data", "model")

@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Immutable logical-axis -> mesh-axes table (plus an optional mesh).

    The attached ``mesh`` is only used by :func:`constrain`, the
    tensor-parallel layers and the sharded train step: rule tables built
    without one (as in unit tests) make ``constrain`` a no-op."""

    table: tuple[tuple[str, Axes], ...] = ()
    mesh: Any = None

    # -- constructors -------------------------------------------------------

    @classmethod
    def of(cls, mesh: Any = None, **rules: Axes) -> "ShardingRules":
        return cls(tuple(sorted(rules.items())), mesh)

    def updated(self, **rules: Axes) -> "ShardingRules":
        d = dict(self.table)
        d.update(rules)
        return dataclasses.replace(self, table=tuple(sorted(d.items())))

    def with_mesh(self, mesh: Any) -> "ShardingRules":
        return dataclasses.replace(self, mesh=mesh)

    # -- queries ------------------------------------------------------------

    def get(self, logical_axis: str, default: Axes = None) -> Axes:
        return dict(self.table).get(logical_axis, default)

    def spec(self, logical_axes: Sequence[str | None]) -> tuple:
        """The partition spec of one array from its logical axis names.

        ``None`` entries stay unsharded.  A mesh axis appears at most once
        in a spec: a repeated one (two logical axes on one mesh axis) is
        dropped left to right, the later entry falling back to replicated,
        as GSPMD requires.  An entry of one mesh axis is its name, as in
        the reference's ``PartitionSpec``."""
        d = dict(self.table)
        used: set[str] = set()
        entries: list[Axes] = []
        for name in logical_axes:
            value = d.get(name) if name is not None else None
            if value is None:
                entries.append(None)
                continue
            if isinstance(value, str):
                if value in used:
                    entries.append(None)
                else:
                    used.add(value)
                    entries.append(value)
                continue
            kept = tuple(a for a in value if a not in used)
            used.update(kept)
            # as the reference's PartitionSpec keeps them: one axis as its
            # name, none as None
            entries.append(kept[0] if len(kept) == 1 else kept or None)
        return tuple(entries)

    def __repr__(self) -> str:  # compact, stable for logging
        body = ", ".join(f"{k}={v!r}" for k, v in self.table)
        return f"ShardingRules({body})"


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


def dp_rules(data_axes: tuple[str, ...] = MESH_AXES) -> ShardingRules:
    """Paper-faithful Lightning distribution: batch superblocks over every
    mesh axis, all weights and optimizer state replicated."""
    return ShardingRules.of(batch=tuple(data_axes))


def tp_rules(
    data: tuple[str, ...] = ("pod", "data"),
    model: str = "model",
    shard_seq: bool = False,
) -> ShardingRules:
    """Megatron-style tensor-parallel placement over ``(data..., model)``.

    ``shard_seq`` also sequence-shards the decode KV cache over the model
    axis (the flash-decode distribution for long contexts)."""
    data = tuple(data)
    return ShardingRules.of(
        batch=data,
        seq=None,
        d_model=None,
        heads=model,
        kv_heads=model,
        kv_seq=model if shard_seq else None,
        d_ff=model,
        vocab=model,
        experts=model,
        experts_buf=model,
        expert_cap=None,
        frames=None,
        head_dim=None,
        layers=None,
        zero1=data,
    )


# ---------------------------------------------------------------------------
# Trees and constraints
# ---------------------------------------------------------------------------


def tree_specs(rules: ShardingRules, logical_axes_tree: Any) -> Any:
    """A tree of logical-axis tuples as a tree of partition specs.

    Leaves are tuples of logical axis names (``None`` for an unnamed dim;
    the empty tuple is a scalar and gives ``()``); dicts and lists are
    walked, and a ``None`` leaf passes through (no constraint)."""
    if logical_axes_tree is None:
        return None
    if isinstance(logical_axes_tree, tuple):
        return rules.spec(logical_axes_tree)
    if isinstance(logical_axes_tree, Mapping):
        return {k: tree_specs(rules, v) for k, v in logical_axes_tree.items()}
    if isinstance(logical_axes_tree, list):
        return [tree_specs(rules, v) for v in logical_axes_tree]
    raise TypeError(f"not a tree of logical axes: {logical_axes_tree!r}")


def model_ranks(mesh: Any) -> int:
    """Ranks along the mesh's ``"model"`` axis (1 where it has none)."""
    return mesh_sizes(mesh).get("model", 1)


def _mesh_axes(entry: Axes) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def model_split(rules: ShardingRules | None, logical_axis: str) -> int:
    """Ranks of the ``"model"`` axis that split ``logical_axis`` under
    ``rules`` on their mesh (1 where the axis is not split over it, or the
    rules carry no mesh)."""
    if rules is None or rules.mesh is None:
        return 1
    if "model" not in _mesh_axes(rules.spec((logical_axis,))[0]):
        return 1
    return model_ranks(rules.mesh)


def seq_run(rules: ShardingRules | None, spec: tuple | None, dim: int,
            local: int | None = None) -> tuple[int, int]:
    """(ranks, offset) of this rank's run of positions along dimension
    ``dim`` of a leaf whose partition spec is ``spec``: the leaf's own
    spec (``models.api.state_specs``), never one logical axis of the rules
    alone, since a spec gives a mesh axis to its first dimension that
    names it (a decode cache's KV heads before its sequence).  ``ranks``
    is how many ranks split that dimension (1 where none does or the rules
    carry no mesh); ``offset`` the first position of this rank's
    ``local`` ones (0 where ``local`` is None or nothing splits it)."""
    if rules is None or rules.mesh is None or not spec or dim >= len(spec):
        return 1, 0
    sizes = mesh_sizes(rules.mesh)
    axes = tuple(a for a in _mesh_axes(spec[dim]) if sizes[a] > 1)
    count = 1
    for a in axes:
        count *= sizes[a]
    if count == 1 or local is None:
        return count, 0
    with use_mesh(rules.mesh):
        return count, axis_index(axes) * local


def constrain(x, rules: ShardingRules | None,
              logical_axes: Sequence[str | None],
              whole: Sequence[int | None] | None = None):
    """``x`` itself, always: each rank holds its part of every array
    already (the batch was split by rank before the model saw it, and the
    tensor-parallel layers hold their slice), so nothing moves.  On a mesh
    whose ``"model"`` axis has more than one rank this is a check: where
    ``whole`` gives the whole array's size of a dimension (None: not
    checked) that the rules split over ``"model"``, ``x``'s size there must
    be the rank's share, which catches a layer that forgot to split."""
    if rules is None or rules.mesh is None:
        return x
    if model_ranks(rules.mesh) == 1:
        return x
    if whole is None:
        return x
    sizes = mesh_sizes(rules.mesh)
    for dim, (entry, size) in enumerate(zip(rules.spec(logical_axes),
                                            whole)):
        axes = _mesh_axes(entry)
        if size is None or "model" not in axes:
            continue
        count = 1
        for a in axes:
            count *= sizes[a]
        if x.shape[dim] * count != size:
            raise ValueError(
                f"{tuple(logical_axes)}: axis {dim} holds {x.shape[dim]} "
                f"of {size}, not the share of one of {count} ranks")
    return x


def batch_axes(rules: ShardingRules | None) -> tuple[str, ...]:
    """The mesh axes the batch is split over, where the rules carry a mesh
    (none otherwise)."""
    if rules is None or rules.mesh is None:
        return ()
    entry = rules.spec(("batch",))[0]
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def batch_ranks(rules: ShardingRules | None) -> int:
    """Ranks the batch is split over (1 where it is not)."""
    axes = batch_axes(rules)
    sizes = mesh_sizes(rules.mesh) if axes else {}
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


def psum_batch(x, rules: ShardingRules | None):
    """The sum of ``x`` over the ranks that split the batch (``x`` itself
    where the batch is not split), differentiable: the global batch's
    statistic that GSPMD forms from a sharded batch, such as the MoE
    router's mean expert load."""
    axes = batch_axes(rules)
    if not axes:
        return x
    with use_mesh(rules.mesh):
        return psum_grad(x, axes)


# ---------------------------------------------------------------------------
# Planner bridge
# ---------------------------------------------------------------------------


def derive_rules_from_plan(
    annotation: str | Annotation,
    *,
    grid_axis_names: tuple[str, ...],
    grid_axis_mesh: Mapping[str, str | None],
    array_ranks: Mapping[str, int],
) -> dict[str, tuple]:
    """Per-array partition specs from a Lightning annotation.

    ``grid_axis_names`` names the launch grid's axes by position and
    ``grid_axis_mesh`` maps each name to a mesh axis (or None to keep that
    grid axis unsharded).  As in the planner's chunk analysis:

    * a dimension indexed by a *point* expression that is exactly one grid
      variable (coefficient 1, no offset) is owner-computes shardable and
      gets that grid axis' mesh axis;
    * a slice, halo (``i-1:i+1``), scaled or offset access needs neighbour
      data, so the dimension is replicated;
    * a mesh axis is used at most once an array, left to right.

    The paper's matmul ``global [i, j] => read A[i,:], read B[:,j],
    write C[i,j]`` over ``{i: data, j: model}`` gives ``A=('data', None)``,
    ``B=(None, 'model')`` and ``C=('data', 'model')``."""
    ann = parse(annotation) if isinstance(annotation, str) else annotation
    var_axes = ann.var_axes()

    def mesh_axis_for(expr) -> str | None:
        # Shardable iff the index is exactly `v` for a global grid var v.
        if expr is None or expr.const != 0 or len(expr.coeffs) != 1:
            return None
        var, coeff = expr.coeffs[0]
        if coeff != 1:
            return None
        space, axis = var_axes[var]
        if space != "global" or axis >= len(grid_axis_names):
            return None
        return grid_axis_mesh.get(grid_axis_names[axis])

    specs: dict[str, tuple] = {}
    for stmt in ann.stmts:
        rank = int(array_ranks.get(stmt.array, len(stmt.indices)))
        used: set[str] = set()
        entries: list[str | None] = []
        for ix in stmt.indices[:rank]:
            axis = mesh_axis_for(ix.lower) if ix.is_point else None
            if axis is not None and axis not in used:
                used.add(axis)
                entries.append(axis)
            else:
                entries.append(None)
        entries.extend([None] * (rank - len(entries)))
        specs[stmt.array] = tuple(entries)
    return specs
