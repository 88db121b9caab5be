"""Per-arch sharding-rule resolution over a concrete mesh.

``rules_for(cfg, mesh, flavor)`` adapts the DP/TP presets to the
architecture and input shape.  Every rule is divisibility-checked, as the
reference's argument shardings must divide their dimensions exactly:

* ``heads`` labels the **flat** projection dims (q_dim / kv_dim): sharded
  over ``model`` when both flat dims divide;
* ``kv_heads`` labels the 4-D KV-cache head axis: sharded only when the
  head *count* divides (MQA with one kv head falls back to replicated);
* ``kv_seq`` (decode): the sequence-sharded cache over ``model``, the
  flash-decode distribution;
* ``batch``: the longest prefix of data axes whose product divides the
  global batch (a batch of 1 is replicated);
* ``vocab`` / ``d_ff`` / ``experts``: plain divisibility.

The ``dp`` flavor is the Lightning-faithful baseline: batch-only
superblocks, all weights replicated.  ``mesh`` is a ``DeviceMesh`` (which
the rules then carry) or an {axis: size} mapping (a pure rule table).
Every family's layers run over a ``"model"`` axis of more than one rank
under these rules (:mod:`repro_torch.dist.tensor_parallel`).
"""

from __future__ import annotations

from repro_torch.dist.ranks import mesh_sizes
from repro_torch.dist.sharding import ShardingRules, dp_rules, tp_rules
from repro_torch.models.config import ModelConfig


def fit_batch_axes(
    mesh, global_batch: int, candidates: tuple[str, ...]
) -> tuple[str, ...] | None:
    """Longest prefix of ``candidates`` whose size product divides batch.
    ``mesh`` may be a ``DeviceMesh`` or an {axis: size} mapping."""
    sizes = mesh_sizes(mesh)
    best: tuple[str, ...] = ()
    prod = 1
    for ax in candidates:
        prod *= sizes[ax]
        if global_batch % prod == 0:
            best = best + (ax,)
        else:
            break
    return best or None


def rules_for(
    cfg: ModelConfig,
    mesh,
    flavor: str = "tp",  # "dp" (paper-faithful baseline) | "tp"
    *,
    global_batch: int | None = None,
    shard_seq: bool = False,
) -> ShardingRules:
    sizes = mesh_sizes(mesh)
    axes = tuple(sizes)
    data_axes = tuple(a for a in axes if a != "model")
    m = sizes.get("model", 1)
    concrete = None if isinstance(mesh, dict) else mesh

    if flavor == "dp":
        # Batch superblocks over as many ranks as the global batch fills;
        # weights replicated.
        batch_axes = (
            fit_batch_axes(mesh, global_batch, axes)
            if global_batch is not None
            else axes
        )
        return (
            dp_rules(data_axes=axes)
            .updated(batch=batch_axes)
            .with_mesh(concrete)
        )

    r = tp_rules(data=data_axes, model="model", shard_seq=shard_seq)
    r = r.with_mesh(concrete)

    if global_batch is not None:
        r = r.updated(batch=fit_batch_axes(mesh, global_batch, data_axes))

    def div(x: int | None) -> bool:
        return x is not None and x > 0 and x % m == 0

    # Flat projection dims.
    if not (div(cfg.q_dim) and div(cfg.kv_dim)):
        r = r.updated(heads=None)
    # 4-D cache head axis: the count must divide.
    r = r.updated(kv_heads="model" if div(cfg.n_kv_heads) else None)
    if not div(cfg.d_ff):
        r = r.updated(d_ff=None)
    if not div(cfg.vocab):
        r = r.updated(vocab=None)
    if not div(cfg.n_experts or None):
        # An expert count the model axis does not divide (granite-3b's 40
        # over 16): the dispatch buffer is sharded by batch only and the
        # expert weights replicated, as the reference found best.
        r = r.updated(experts=None, experts_buf=None)
    if shard_seq:
        # the decode cache's length must divide too
        r = r.updated(kv_seq="model")
    if cfg.family == "rwkv":
        r = r.updated(heads="model" if div(cfg.d_model) else None)
    return r
