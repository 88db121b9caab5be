"""Dense decoder-only transformer (phi3 / gemma / stablelm / qwen families,
and the InternVL backbone).

GQA/MQA attention with RoPE, SwiGLU/GeGLU MLPs, RMSNorm or LayerNorm,
optional QKV bias (qwen).  The parameters are an ``nn.Module``: a
``DecoderLayer`` per layer in an ``nn.ModuleList``, in place of the
reference's layer-stacked pytree that ``lax.scan`` walks, with the
reference's weight layout (``x @ W``, W of shape (in, out)), so that
carrying weights across is a split along the reference's layer axis.  The
forward pass is a Python loop over the layers, run eagerly.

Over a ``"model"`` axis of more than one rank (``rules`` from ``rules_for``
on a mesh of ranks) each rank holds its slice of the weights the rules
split (``models.api.init_params`` and ``local_params`` make it) and runs
the Megatron layers of :mod:`repro_torch.dist.tensor_parallel`: q, k and v
column-split by heads and ``wo`` row-split, then summed over the ranks;
the MLP likewise by d_ff; the embedding and the logits split by vocab.
Where the rules split ``kv_dim`` but not the KV heads (one KV head, as
gemma's MQA), the ranks gather k and v whole and each attends its own q
heads to them; where a rank's share of ``q_dim`` is not whole heads
(gemma-2b, qwen1.5-32b and granite-moe-3b over 16 ranks), they gather q
too, attend every head, and each keeps its columns of the output.
Where the cache's spec splits its sequence over the ranks instead (the
reference's ``shard_seq``, only where the KV heads stay whole), a decode
step attends every query head to the rank's run of the cache and combines
the ranks' partials by their lse (``seq_split_decode``; under a sliding
window, to the positions of its run that the window keeps).
Prefill and decode logits are gathered over the ranks, so that a caller
sees the whole vocab; train logits stay split and the loss is the
vocab-parallel cross-entropy.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from repro_torch.dist import ranks
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import constrain, model_split

from . import kvcache
from .attention import (
    combine_decode_partials,
    decode_attention,
    decode_attention_masked,
    decode_attention_quant,
    decode_attention_seq_split,
    multihead_attention,
)
from .config import ModelConfig
from .layers import (
    apply_norm,
    apply_rope_tables,
    causal_lm_loss,
    fan_in_init,
    init_device,
    mlp_apply,
    mlp_init,
    mlp_logical_axes,
    norm_init,
    normal_init,
    remat_call,
    rope_tables,
)
from .layers import remat_policy_of  # noqa: F401  (public, as the reference's)

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class DecoderLayer(nn.Module):
    """One layer's weights: ``attn_norm``, ``wq``/``wk``/``wv``/``wo``
    (and ``bq``/``bk``/``bv`` with a QKV bias), ``mlp_norm``, ``mlp``."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, value in tensors.items():
            if isinstance(value, dict):
                setattr(self, name, _params(value))
            else:
                setattr(self, name, nn.Parameter(value, requires_grad=False))


class Transformer(nn.Module):
    """``embed`` (vocab, d_model), ``layers``, ``final_norm`` and, unless
    the embeddings are tied, ``lm_head`` (d_model, vocab)."""

    def __init__(self, embed: torch.Tensor, layers: list[dict],
                 final_norm: dict, lm_head: torch.Tensor | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(t) for t in layers)
        self.final_norm = _params(final_norm)
        if lm_head is not None:
            self.lm_head = nn.Parameter(lm_head, requires_grad=False)


def init_layer(generator: torch.Generator, cfg: ModelConfig,
               device: torch.device) -> dict:
    dt = cfg.torch_dtype
    p = {
        "attn_norm": norm_init(cfg.d_model, cfg.norm, dt, device),
        "wq": fan_in_init(generator, (cfg.d_model, cfg.q_dim), dt, device),
        "wk": fan_in_init(generator, (cfg.d_model, cfg.kv_dim), dt, device),
        "wv": fan_in_init(generator, (cfg.d_model, cfg.kv_dim), dt, device),
        "wo": fan_in_init(generator, (cfg.q_dim, cfg.d_model), dt, device),
        "mlp_norm": norm_init(cfg.d_model, cfg.norm, dt, device),
        "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                        device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dt, device=device)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=device)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=device)
    return p


def layer_logical_axes(cfg: ModelConfig) -> dict:
    norm_ax = (
        {"scale": ("d_model",)}
        if cfg.norm == "rmsnorm"
        else {"scale": ("d_model",), "bias": ("d_model",)}
    )
    p = {
        "attn_norm": dict(norm_ax),
        "wq": ("d_model", "heads"),
        "wk": ("d_model", "heads"),
        "wv": ("d_model", "heads"),
        "wo": ("heads", "d_model"),
        "mlp_norm": dict(norm_ax),
        "mlp": mlp_logical_axes(cfg.activation),
    }
    if cfg.qkv_bias:
        p["bq"] = ("heads",)
        p["bk"] = ("heads",)
        p["bv"] = ("heads",)
    return p


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str | None = None) -> Transformer:
    """Random parameters made on ``device`` (None: the GPU) from
    ``generator``, which must live on that device."""
    device = init_device(generator, device)
    dt = cfg.torch_dtype
    embed = normal_init(generator, (cfg.vocab, cfg.d_model), 0.02, dt, device)
    layers = [init_layer(generator, cfg, device) for _ in range(cfg.n_layers)]
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = fan_in_init(generator, (cfg.d_model, cfg.vocab), dt, device)
    return Transformer(embed, layers,
                       norm_init(cfg.d_model, cfg.norm, dt, device), lm_head)


def params_logical_axes(cfg: ModelConfig) -> dict:
    def stack(ax):
        if isinstance(ax, dict):
            return {k: stack(v) for k, v in ax.items()}
        return ("layers",) + ax

    p = {
        "embed": ("vocab", "d_model"),
        "layers": stack(layer_logical_axes(cfg)),
        "final_norm": (
            {"scale": ("d_model",)}
            if cfg.norm == "rmsnorm"
            else {"scale": ("d_model",), "bias": ("d_model",)}
        ),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ("d_model", "vocab")
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _kv_heads_for(cfg: ModelConfig, hq: int, hkv: int,
                  mesh) -> tuple[int, int]:
    """(first, count) of the KV heads of ``k`` and ``v`` that this rank's
    ``hq`` query heads attend to, where the rank holds ``hkv`` of them:
    all of them where the rules split the KV heads with the query heads
    (each rank its own group), else, with the KV heads whole on every rank
    (one KV head, or a count the "model" axis does not divide), the ones of
    the rank's contiguous run of query heads."""
    if hkv * cfg.n_heads == hq * cfg.n_kv_heads:
        return 0, hkv
    group = cfg.n_heads // cfg.n_kv_heads
    with ranks.use_mesh(mesh):
        lo = ranks.axis_index(tp.MODEL) * hq
    if hq % group == 0:
        return lo // group, hq // group
    if group % hq == 0:
        return lo // group, 1
    raise NotImplementedError(
        f"{hq} query heads a rank straddle the KV heads' groups of {group}")


def _q_heads(lp, h: torch.Tensor, cfg: ModelConfig, rules,
             whole: bool = False):
    """q (B, S, heads, head_dim) of ``h`` (already past ``copy_to_model``
    where the heads split) and the columns the rank keeps (``tp_qkv``);
    ``whole``: every head, gathered where the heads split."""
    b, s, _ = h.shape
    q = h @ lp.wq
    if cfg.qkv_bias:
        q = q + lp.bq
    q = constrain(q, rules, ("batch", "seq", "heads"), (None, None, cfg.q_dim))
    d = cfg.head_dim
    cols = None
    if model_split(rules, "heads") > 1 and (whole or q.shape[-1] % d):
        # a rank's query columns are not whole heads (the rules split
        # q_dim, as GSPMD may), or the caller attends every head (a cache
        # split by sequence): every rank gathers q whole, attends every
        # head, and keeps its columns of the output for its rows of wo
        with ranks.use_mesh(rules.mesh):
            lo = ranks.axis_index(tp.MODEL) * q.shape[-1]
        cols = slice(lo, lo + q.shape[-1])
        q = tp.gather_from_model(q, -1, rules.mesh)
    return q.reshape(b, s, q.shape[-1] // d, d), cols


def _kv_heads(lp, h: torch.Tensor, cfg: ModelConfig, rules):
    """k and v (B, S, heads, head_dim) of ``h`` (already past
    ``copy_to_model`` where the heads split): the rank's KV heads, or all
    of them where the rules split kv_dim but not the KV heads."""
    b, s, _ = h.shape
    k = h @ lp.wk
    v = h @ lp.wv
    if cfg.qkv_bias:
        k, v = k + lp.bk, v + lp.bv
    k = constrain(k, rules, ("batch", "seq", "heads"),
                  (None, None, cfg.kv_dim))
    v = constrain(v, rules, ("batch", "seq", "heads"),
                  (None, None, cfg.kv_dim))
    if model_split(rules, "heads") > 1 and \
            model_split(rules, "kv_heads") == 1:
        # the axis splits kv_dim but not the KV heads: every rank takes
        # them whole (before RoPE, which works per head)
        k = tp.gather_from_model(k, -1, rules.mesh)
        v = tp.gather_from_model(v, -1, rules.mesh)
    d = cfg.head_dim
    return (k.reshape(b, s, k.shape[-1] // d, d),
            v.reshape(b, s, v.shape[-1] // d, d))


def _to_ranks(h: torch.Tensor, rules) -> torch.Tensor:
    """``h`` through ``copy_to_model`` where ``rules`` split the heads."""
    if model_split(rules, "heads") > 1:
        return tp.copy_to_model(h, rules.mesh)
    return h


def kv_heads_attended(cfg: ModelConfig, hq: int, hkv: int, rules) -> slice:
    """The KV heads of a rank's ``hkv`` that its ``hq`` query heads attend
    to (``_kv_heads_for``)."""
    mesh = rules.mesh if model_split(rules, "heads") > 1 else None
    lo, n = _kv_heads_for(cfg, hq, hkv, mesh)
    return slice(lo, lo + n)


def tp_q(lp, h: torch.Tensor, cfg: ModelConfig, rules):
    """q alone (as ``tp_qkv``), for a query against a cache of keys made
    before: (q, the columns this rank keeps)."""
    return _q_heads(lp, _to_ranks(h, rules), cfg, rules)


def tp_qkv(lp, h: torch.Tensor, cfg: ModelConfig, rules,
           h_kv: torch.Tensor | None = None, whole_q: bool = False):
    """q of the normed input ``h`` (B, S, D) and k and v of ``h_kv`` (None:
    ``h``; the encoder's output for a cross-attention), as (B, S, heads,
    head_dim) before RoPE, from ``lp``'s ``wq``, ``wk``, ``wv`` (and QKV
    biases), with the columns (None: all of them) that this rank keeps of
    the attention's output and the slice of k's heads its queries attend
    to.  Where ``rules`` split the heads over more than one rank of
    ``"model"``, each input passes ``copy_to_model`` once and the products
    are the rank's columns; k and v are gathered whole where the KV heads
    are not split (one KV head, as gemma's MQA), and q too where a rank's
    query columns are not whole heads or ``whole_q`` asks for every head
    (every rank then attends every head and keeps its columns).  The head
    counts are the weights' own."""
    hc = _to_ranks(h, rules)
    q, cols = _q_heads(lp, hc, cfg, rules, whole_q)
    k, v = _kv_heads(lp, hc if h_kv is None else _to_ranks(h_kv, rules),
                     cfg, rules)
    return q, k, v, cols, kv_heads_attended(cfg, q.shape[2], k.shape[2],
                                            rules)


def tp_out(lp, out: torch.Tensor, cfg: ModelConfig, rules,
           cols: slice | None) -> torch.Tensor:
    """The attention's output (B, S, heads x head_dim) through ``wo``:
    this rank's ``cols`` of it (``tp_qkv``) through its rows of ``wo``,
    summed over the ranks where ``rules`` split the heads."""
    if cols is not None:
        out = out[..., cols]
    out = constrain(out, rules, ("batch", "seq", "heads"),
                    (None, None, cfg.q_dim))
    out = out @ lp.wo
    if model_split(rules, "heads") > 1:
        out = tp.reduce_from_model(out, rules.mesh)
    return out


def _attention_block(
    lp: DecoderLayer,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    rules,
    positions: torch.Tensor,  # (B, S)
    mode: str,
    cache_l: dict | None,
    window: int | None = None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
    run: tuple[int, int] = kvcache.WHOLE,
):
    """``rope``: the forward pass's ``rope_tables`` for ``positions``
    (made here when not given); ``run``: the cache's ``kvcache.seq_run``
    (the forward pass's).  The head counts are the weights' own: this
    rank's heads where the rules split them (``tp_qkv``), every head in a
    decode over a cache split by sequence."""
    b, s, _ = x.shape
    d = cfg.head_dim
    split = mode == "decode" and run[0] > 1
    q, k, v, cols, mine = tp_qkv(lp, apply_norm(x, lp.attn_norm, cfg.norm),
                                 cfg, rules, whole_q=split)
    hq = q.shape[2]
    if rope is None:
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope_tables(q, *rope)
    k = apply_rope_tables(k, *rope)
    q = q.transpose(1, 2)  # (B, H, S, D)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    def project(out):
        return x + tp_out(lp, out, cfg, rules, cols)

    new_cache_l = None
    if mode == "decode":
        assert cache_l is not None
        new_cache_l = kvcache.update_layer(cfg, cache_l, k, v, positions[:, 0],
                                           run)
        kv_len = positions[:, 0] + 1
        fused = cfg.kv_quant and cfg.kv_fused and window is None
        if split:
            if fused:
                k_full, v_full = new_cache_l["k_q"], new_cache_l["v_q"]
                scales = new_cache_l["k_s"], new_cache_l["v_s"]
            else:
                k_full, v_full = kvcache.read_layer(cfg, new_cache_l)
                scales = None
            out = seq_split_decode(q[:, :, 0], k_full, v_full, kv_len, run[1],
                                   cfg, rules, scales=scales, window=window)
            return project(out), new_cache_l
        if fused:
            # Attend on the int8 cache directly: the scales factor out of
            # both dots, and the kernel reads the cache once, in int8 (the
            # plain version, for a CPU tensor or another impl, widens it).
            out = decode_attention_quant(
                q[:, :, 0],
                new_cache_l["k_q"][:, mine], new_cache_l["k_s"][:, mine],
                new_cache_l["v_q"][:, mine], new_cache_l["v_s"][:, mine],
                kv_len, impl=cfg.attention_impl,
            )
            out = out[:, :, None, :].transpose(1, 2)
            return project(out.reshape(b, s, hq * d)), new_cache_l
        k_full, v_full = kvcache.read_layer(cfg, new_cache_l)
        k_full, v_full = _heads(k_full, mine), _heads(v_full, mine)
        if window is not None:
            out = _windowed_decode(q[:, :, 0], k_full, v_full, kv_len, window)
        else:
            out = decode_attention(
                q[:, :, 0], k_full, v_full, kv_len,
                impl="cuda" if cfg.attention_impl == "cuda" else "xla",
            )
        out = out[:, :, None, :]  # (B, H, 1, D)
    else:
        if mode == "prefill" and cache_l is not None:
            new_cache_l = kvcache.update_layer(
                cfg, cache_l, k, v,
                torch.zeros((b,), dtype=torch.int32, device=x.device), run)
        out = multihead_attention(
            q, _heads(k, mine), _heads(v, mine),
            impl=cfg.attention_impl, causal=True, window=window,
        )
    out = out.transpose(1, 2).reshape(b, s, hq * d)
    return project(out), new_cache_l


def seq_split_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, offset: int, cfg: ModelConfig,
                     rules, *, scales=None,
                     window: int | None = None) -> torch.Tensor:
    """Decode attention of ``q`` (B, heads, head_dim), every query head
    (``tp_qkv(..., whole_q=True)``), against the rank's run of a cache
    split by sequence over ``"model"`` (k and v (B, KV, T_local,
    head_dim), every KV head, since the spec splits the sequence only
    where it keeps the KV heads whole; ``scales``: an int8 cache's (k_s,
    v_s)), the ranks' partials combined (``decode_attention_seq_split``):
    the output (B, 1, q_dim).  With a sliding ``window`` the rank's
    valid positions, ``[max(kv_len - window, 0), kv_len)`` within its
    run, are not a prefix of it: it attends to them by their mask
    (``decode_attention_masked``, f32 logits as ``_windowed_decode``) and
    the partials go through the same combine."""
    if window is None:
        out = decode_attention_seq_split(
            q, k, v, kv_len, offset, tp.MODEL, mesh=rules.mesh,
            impl="cuda" if cfg.attention_impl == "cuda" else "xla",
            scales=scales)
    else:
        out, lse = decode_attention_masked(
            q, k, v, _window_mask(kv_len, window, offset, k.shape[2]))
        with ranks.use_mesh(rules.mesh):
            out = combine_decode_partials(out, lse, tp.MODEL)
    return out.reshape(q.shape[0], 1, -1)


def _heads(x: torch.Tensor, mine: slice) -> torch.Tensor:
    """KV heads ``mine`` of (B, H, T, D): ``x`` itself where that is all of
    them, else a contiguous copy."""
    if mine.start == 0 and mine.stop == x.shape[1]:
        return x
    return x[:, mine].contiguous()


def _window_mask(kv_len: torch.Tensor, window: int, offset: int,
                 t: int) -> torch.Tensor:
    """(B, t): which of positions ``offset .. offset + t - 1`` a sliding
    window keeps, ``[max(kv_len - window, 0), kv_len)`` of each row."""
    pos = offset + torch.arange(t, device=kv_len.device)
    lo = torch.clamp(kv_len - window, min=0)[:, None]
    return (pos >= lo) & (pos < kv_len[:, None])


def _windowed_decode(q, k, v, kv_len, window):
    """Decode attention with a sliding window: positions below
    kv_len - window are masked out (materialized path; window caches are
    small)."""
    return decode_attention_masked(
        q, k, v, _window_mask(kv_len, window, 0, k.shape[2]))[0]


def _layer_fn(cfg: ModelConfig, rules, mode: str, x: torch.Tensor,
              lp: DecoderLayer, cache_l: dict | None,
              positions: torch.Tensor, rope=None, run=kvcache.WHOLE):
    x = constrain(x, rules, ("batch", "seq", "d_model"))
    x, new_cache_l = _attention_block(
        lp, x, cfg, rules, positions, mode, cache_l, rope=rope, run=run
    )
    h = apply_norm(x, lp.mlp_norm, cfg.norm)
    x = x + mlp_apply(lp.mlp, h, cfg.activation, rules)
    x = constrain(x, rules, ("batch", "seq", "d_model"))
    return x, new_cache_l


def forward(
    params: Transformer,
    tokens: torch.Tensor,  # (B, S) int — or (B, S, D) pre-embedded
    cfg: ModelConfig,
    rules=None,
    mode: str = "train",  # train | prefill | decode
    cache: kvcache.Cache | None = None,
    extra_embeds: torch.Tensor | None = None,  # VLM patch embeds (B, P, D)
) -> tuple[torch.Tensor, kvcache.Cache | None]:
    """Logits (B, S, vocab), or (B, 1, vocab) in decode mode, and the cache.
    The cache's buffers are written in place; the returned dict holds them
    with ``pos`` advanced by S (a new tensor).  Where ``rules`` split the
    vocab over more than one rank of ``"model"``, train logits are this
    rank's slice of the vocab."""
    x = _embed(params, tokens, rules) if tokens.ndim == 2 else tokens
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        # The scale rounded to x's type first, as the reference's
        # jnp.asarray(sqrt(d), x.dtype); a Python float, so that no tensor
        # is copied to the device (a copy that waits for it).  Under a
        # vocab split, after the sum over the ranks.
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape

    steps = torch.arange(s, device=x.device, dtype=torch.int32)
    if mode == "decode":
        assert cache is not None
        positions = cache["pos"][:, None] + steps[None, :]
    else:
        positions = steps[None, :].expand(b, s)
    # One set of rotation tables for every layer (the reference computes
    # them in each layer; the numbers are the same).
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    layer_caches = kvcache.layer_slice(cache) if cache is not None else None
    run = kvcache.cache_run(cache, rules)
    for i, lp in enumerate(params.layers):
        cache_l = None
        if layer_caches is not None:
            cache_l = {name: buf[i] for name, buf in layer_caches.items()}
        x, _ = remat_call(cfg, mode, _layer_fn, cfg, rules, mode, x, lp,
                          cache_l, positions, rope, run)

    new_cache = None
    if cache is not None:
        new_cache = dict(cache)
        new_cache["pos"] = cache["pos"] + (s if mode in ("decode", "prefill")
                                           else 0)

    return _logits(params, x, cfg, rules, mode), new_cache


def _embed(params, tokens: torch.Tensor, rules) -> torch.Tensor:
    """The embedding's rows of ``tokens`` (B, S): from this rank's slice of
    the table and summed over the ranks where ``rules`` split the vocab."""
    if model_split(rules, "vocab") > 1:
        return tp.vocab_parallel_embed(params.embed, tokens, rules.mesh)
    return params.embed[tokens.long()]


def _logits(params, x: torch.Tensor, cfg: ModelConfig, rules,
            mode: str) -> torch.Tensor:
    """The final norm and the head on the last hidden state ``x`` (its last
    position in decode mode).  Where ``rules`` split the vocab, train
    logits are this rank's slice and the others gathered whole."""
    x = apply_norm(x, params.final_norm, cfg.norm)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    if mode == "decode":
        x = x[:, -1:, :]
    return lm_head(x, head, cfg, rules, mode)


def lm_head(x: torch.Tensor, head: torch.Tensor, cfg: ModelConfig, rules,
            mode: str) -> torch.Tensor:
    """``x @ head``, ``head`` (d_model, vocab) this rank's columns where
    ``rules`` split the vocab: then ``x`` passes ``copy_to_model``, and the
    logits are gathered whole except in train mode, whose loss is the
    vocab-parallel cross-entropy."""
    vocab_split = model_split(rules, "vocab") > 1
    if vocab_split:
        x = tp.copy_to_model(x, rules.mesh)
    logits = x @ head
    logits = constrain(logits, rules, ("batch", "seq", "vocab"),
                       (None, None, cfg.vocab))
    if vocab_split and mode != "train":
        logits = tp.gather_from_model(logits, -1, rules.mesh)
    return logits


def train_loss(
    params: Transformer,
    batch: dict,
    cfg: ModelConfig,
    rules=None,
) -> torch.Tensor:
    logits, _ = forward(
        params, batch["tokens"], cfg, rules, mode="train",
        extra_embeds=batch.get("patch_embeds"),
    )
    if batch.get("patch_embeds") is not None:
        p = batch["patch_embeds"].shape[1]
        logits = logits[:, p:, :]
    return causal_lm_loss(logits, batch["tokens"], rules)
