"""Family-dispatched model API used by the serving and training drivers.

Every family implements ``init_params``, ``train_loss``, ``prefill`` and
``decode_step`` and exposes logical-axis trees for params and decode state:
the dense and VLM families (``transformer``), the MoE family (``moe``),
RWKV-6 (``rwkv``), the RecurrentGemma hybrid (``rglru``) and the Whisper
encoder-decoder (``encdec``), whose prefill also takes the encoder's input
frames (``batch["frames"]``).

Every family runs over a ``"model"`` axis of ranks (``rules`` from
``rules_for`` on a mesh): ``init_params`` and ``local_params`` give a rank
its slices by ``param_specs``, ``init_decode_state`` its part of the decode
state by ``state_specs``, and the family's layers run the tensor-parallel
operators of :mod:`repro_torch.dist.tensor_parallel`.
"""

from __future__ import annotations

import torch

from repro_torch.dist import ranks
from repro_torch.dist.ranks import BlockedSpec
from repro_torch.dist.sharding import tree_specs

from . import encdec, kvcache, moe, rglru, rwkv, transformer
from .config import ModelConfig

#: the module of each family
_FAMILIES = {"dense": transformer, "vlm": transformer, "moe": moe,
             "rwkv": rwkv, "hybrid": rglru, "encdec": encdec}
#: the families whose decode state is the KV cache of ``kvcache``
_KV_CACHED = (transformer, moe)


def _family(cfg: ModelConfig):
    """The module of ``cfg``'s family."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str | None = None, rules=None):
    """Random parameters on ``device`` (None: the GPU).  With ``rules`` on
    a mesh of ranks, this rank's part of them: the whole model made from
    ``generator`` and then sliced by its specs (``local_params``), so that
    one rank and several start from the same weights."""
    params = _family(cfg).init_params(generator, cfg, device)
    return local_params(params, cfg, rules)


def local_params(params, cfg: ModelConfig, rules):
    """``params`` (the whole model) cut, in place, to this rank's slice of
    each leaf that ``rules`` split over ranks of their mesh (``"model"``:
    heads, d_ff, vocab; a parameter is never split over the batch axes),
    by ``param_specs``; ``params`` itself where they split none."""
    if rules is None or rules.mesh is None:
        return params
    specs = param_specs(cfg, rules)
    with ranks.use_mesh(rules.mesh), torch.no_grad():
        for name, p in params.named_parameters():
            if ranks.spec_shards(specs[name]):
                p.data = ranks.spec_slice(p.data, specs[name]).clone(
                    memory_format=torch.contiguous_format)
    return params


def param_specs(cfg: ModelConfig, rules) -> dict[str, tuple]:
    """The partition spec of each parameter under ``rules``, keyed by its
    name in ``named_parameters()`` (``blocked_specs`` of the tree
    specs)."""
    return blocked_specs(cfg, tree_specs(rules,
                                         params_logical_axes_by_name(cfg)))


def blocked_specs(cfg: ModelConfig, specs: dict[str, tuple]
                  ) -> dict[str, tuple]:
    """``specs`` (keyed by parameter name) with each leaf that the family
    lays out as blocks end to end (its ``BLOCKED``: the hybrid's ``w_in``,
    [z | y]) given as a ``ranks.BlockedSpec``, so that a rank's slice holds
    its part of each block and the whole leaf stays the reference's."""
    blocked = getattr(_family(cfg), "BLOCKED", {})
    out = dict(specs)
    for name, spec in specs.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in blocked and spec is not None:
            out[name] = BlockedSpec(spec, *blocked[leaf])
    return out


def param_shapes(cfg: ModelConfig) -> torch.nn.Module:
    """The parameter module on the ``meta`` device: every leaf's shape and
    dtype, with no memory behind them (the reference's
    ``jax.eval_shape`` of ``init_params``)."""
    return _family(cfg).init_params(None, cfg, "meta")


def params_logical_axes(cfg: ModelConfig) -> dict:
    return _family(cfg).params_logical_axes(cfg)


def params_logical_axes_by_name(cfg: ModelConfig) -> dict[str, tuple]:
    """The logical axes of each parameter of the port's module, keyed by
    its name in ``named_parameters()``: ``params_logical_axes``'s tree with
    its stacked layers taken apart (an entry a layer, the leading
    ``"layers"`` axis dropped) and its lists by index."""
    counts = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
              "dec_layers": cfg.n_layers}
    if cfg.family == "hybrid":
        counts["groups"] = rglru.n_groups(cfg)[0]
    out: dict[str, tuple] = {}

    def walk(tree, prefix: str, stacked: bool) -> None:
        if isinstance(tree, tuple):
            out[prefix.rstrip(".")] = tree[1:] if stacked else tree
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}.", stacked)
        else:
            for k, v in tree.items():
                if k in counts and not stacked:
                    for i in range(counts[k]):
                        walk(v, f"{prefix}{k}.{i}.", True)
                else:
                    walk(v, f"{prefix}{k}.", stacked)

    walk(params_logical_axes(cfg), "", False)
    return out


def param_count(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def train_loss(params, batch: dict, cfg: ModelConfig,
               rules=None) -> torch.Tensor:
    return _family(cfg).train_loss(params, batch, cfg, rules)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device: torch.device | str | None = None,
                      rules=None) -> dict:
    """An empty KV cache, or recurrent state, on ``device`` (None: the
    GPU); where ``rules`` split it over ranks of ``"model"``, this rank's
    part of it (``state_specs``): its KV heads, its recurrent channels, or
    its WKV heads."""
    mod = _family(cfg)
    if mod in _KV_CACHED:
        return kvcache.init_cache(cfg, batch, max_len, device=device,
                                  rules=rules)
    if mod is encdec:
        return encdec.init_cache(cfg, batch, max_len, device, rules)
    return mod.init_state(cfg, batch, device, rules)


def state_logical_axes(cfg: ModelConfig) -> dict:
    mod = _family(cfg)
    if mod in _KV_CACHED:
        return kvcache.cache_logical_axes(cfg)
    if mod is encdec:
        return encdec.cache_logical_axes(cfg)
    return mod.state_logical_axes(cfg)


def state_specs(cfg: ModelConfig, rules) -> dict:
    """The partition spec of every leaf of the decode state under
    ``rules``: the reference's (``state_logical_axes``), as the family's
    ``state_specs`` hook, where it has one, places them (RWKV-6 splits its
    WKV state by head where a rank's columns are whole heads; the
    reference keeps it whole on every rank).  What ``init_decode_state``
    makes on a rank is its slice of the whole state under these specs."""
    specs = tree_specs(rules, state_logical_axes(cfg))
    hook = getattr(_family(cfg), "state_specs", None)
    return specs if hook is None else hook(cfg, rules, specs)


@torch.no_grad()
def forward(params, tokens: torch.Tensor, cfg: ModelConfig, rules=None,
            mode: str = "train", state: dict | None = None,
            extra_embeds: torch.Tensor | None = None,
            frames: torch.Tensor | None = None):
    """The family's forward pass: logits of every position ((B, 1, V) in
    decode mode) and the new state (a dense or MoE model's KV cache is its
    state).  The encoder-decoder family reads ``frames`` (B, F, D), the
    encoder's input, in train and prefill mode; its prefill here returns
    the logits of every prompt position, where ``prefill`` keeps the
    last."""
    mod = _family(cfg)
    if mod is transformer:
        return transformer.forward(params, tokens, cfg, rules, mode=mode,
                                   cache=state, extra_embeds=extra_embeds)
    if mod is moe:
        logits, state, _ = moe.forward(params, tokens, cfg, rules, mode=mode,
                                       cache=state)
        return logits, state
    if mod is encdec:
        if mode == "decode":
            return encdec.decode_step(params, tokens, cfg, state, rules)
        if mode == "prefill":
            x, state = encdec._prefill_hidden(params, tokens, frames, cfg,
                                              state, rules)
            return transformer.lm_head(x, params.embed.T, cfg, rules,
                                       mode), state
        enc_out = encdec.encode(params, frames, cfg, rules)
        return encdec.decode_train(params, tokens, enc_out, cfg, rules), None
    return mod.forward(params, tokens, cfg, rules, mode=mode, state=state,
                       extra_embeds=extra_embeds)


@torch.no_grad()
def prefill(params, batch: dict, cfg: ModelConfig, state: dict, rules=None):
    """Process the prompt; returns (last-token logits, updated state)."""
    if _family(cfg) is encdec:
        return encdec.prefill(params, batch["tokens"], batch["frames"], cfg,
                              state, rules)
    logits, state = forward(params, batch["tokens"], cfg, rules, "prefill",
                            state, batch.get("patch_embeds"))
    return logits[:, -1:, :], state


def decode_step(params, token: torch.Tensor, cfg: ModelConfig, state: dict,
                rules=None):
    """One new token (B, 1) against the cache; returns (logits (B, 1, V),
    state)."""
    return forward(params, token, cfg, rules, "decode", state)


# ---------------------------------------------------------------------------
# Model FLOPs (for roofline: 6·N·D dense / 6·N_active·D MoE)
# ---------------------------------------------------------------------------


def model_flops_per_token(cfg: ModelConfig,
                          n_params: int | None = None) -> float:
    """6 x (active) params: the standard training-FLOPs estimate."""
    n = n_params if n_params is not None else active_param_estimate(cfg)
    return 6.0 * n


def model_flops_for(cfg: ModelConfig, kind: str, batch: int,
                    seq: int) -> float:
    """MODEL_FLOPS for one step of a (kind x shape) cell.  Enc-dec charges
    the encoder per frame and the decoder per token."""
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[kind]
    if cfg.family == "encdec":
        d = cfg.d_model
        gates = 3 if cfg.activation in ("swiglu", "geglu") else 2
        enc_p = cfg.n_enc_layers * (4 * d * d + gates * d * cfg.d_ff)
        dec_p = cfg.n_layers * (8 * d * d + gates * d * cfg.d_ff) \
            + cfg.vocab * d
        if kind == "train" or kind == "prefill":
            enc_tokens = batch * cfg.enc_frames
            dec_tokens = batch * seq
        else:  # decode: one token, cross-attn reads cached enc KV
            enc_tokens = 0
            dec_tokens = batch
        return mult * (enc_p * enc_tokens + dec_p * dec_tokens)
    tokens = batch * seq if kind != "decode" else batch
    return mult * active_param_estimate(cfg) * tokens


def active_param_estimate(cfg: ModelConfig) -> float:
    """Parameter count from config (active params for MoE)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    embed = V * d * (1 if cfg.tie_embeddings else 2)
    attn = L * (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d)
    gates = 3 if cfg.activation in ("swiglu", "geglu") else 2
    if cfg.family == "moe":
        mlp = L * (cfg.top_k * gates * d * cfg.d_ff + d * cfg.n_experts)
    elif cfg.family == "rwkv":
        attn = L * (6 * d * d)  # r,k,v,g,o + lora
        mlp = L * (2 * d * cfg.d_ff + d * d)
    elif cfg.family == "hybrid":
        g, tail = rglru.n_groups(cfg)
        rec = (2 * g + tail) * (2 * d * d + 2 * d * d + d * d)
        att = g * (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d)
        return embed + rec + att + L * gates * d * cfg.d_ff
    else:
        mlp = L * gates * d * cfg.d_ff
    total = embed + attn + mlp
    if cfg.family == "encdec":
        total += cfg.n_enc_layers * (
            4 * d * d + (3 if cfg.activation != "gelu" else 2) * d * cfg.d_ff
        )
        total += L * 4 * d * d  # cross-attention
    return total
