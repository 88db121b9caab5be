"""RWKV-6 "Finch" (arXiv:2404.05892) — attention-free decoder.

Per layer: a *time-mix* block (token shift, data-dependent per-channel decay,
the WKV6 state recurrence, grouped output norm, silu gate) and a
*channel-mix* block (token shift + squared-relu FFN).  State per layer for
decode: the (K×V) WKV matrix per head plus the previous token's activations
for the two token shifts — O(1) in sequence length.

The parameters are an ``nn.Module`` with one ``DecoderLayer`` of weights a
layer, in the reference's (in, out) layout; the forward pass is a Python
loop over the layers.  With ``attention_impl="cuda"`` the recurrence is the
hand-written WKV6 kernel (on a CPU tensor its wrapper takes the plain
version); otherwise the plain ``wkv6_ref``.  The decode state is never
written in place: each call returns new state tensors.

Over a ``"model"`` axis of more than one rank (``rules`` from ``rules_for``
on a mesh of ranks, which split ``heads`` where d_model divides) each rank
holds its columns of ``wr``, ``wk``, ``wv``, ``wg``, ``wb``, ``w0`` and
``gn_scale`` and its rows of ``wo``, and ``ck`` / ``cv`` split by d_ff as
an MLP; ``mu``, ``mu_c``, ``wa``, ``cr`` and ``bonus`` are whole.
``copy_to_model`` sits on the input of each column-split product (``xr``,
``xk``, ``xv``, ``xg`` and ``tanh(xw @ wa)``; in the channel mix ``xk``
alone, as ``xr`` feeds the whole ``cr``), so that the gradients of the
whole leaves before them are summed over the ranks once; ``wo`` and ``cv``
are row-split and their products summed by ``reduce_from_model``.  Where
a rank's columns are whole WKV heads, the rank runs the recurrence on its
heads with their rows of ``bonus`` and keeps their state
(``wkv_head_split``); where they are not (2.5 heads a rank of rwkv6-3b
over 16), the ranks gather r, k, v and w whole, run every head with the
whole state, group-norm every head, and each keeps its columns.  The
embedding and the head split by vocab, as the dense family's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist import ranks
from repro_torch.dist import tensor_parallel as tp
from repro_torch.dist.sharding import constrain, model_split
from repro_torch.kernels.rwkv6 import wkv6, wkv6_ref

from .config import ModelConfig
from .layers import (causal_lm_loss, fan_in_init, init_device, norm_init,
                     normal_init, remat_call, rms_norm)
from .layers import remat_policy_of  # noqa: F401  (public, as the reference's)
from .transformer import Transformer, _embed, _logits

LORA_DIM = 64
#: parameters the reference creates in f32 whatever ``cfg.dtype`` is
FLOAT32_PARAMS = ("bonus",)


class RWKV(Transformer):
    """``embed`` (vocab, d_model), ``layers`` (one ``DecoderLayer`` of
    time-mix and channel-mix weights each), ``final_norm``, ``lm_head``."""


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.wkv_head_dim


def init_layer(generator: torch.Generator, cfg: ModelConfig,
               device: torch.device) -> dict:
    dt = cfg.torch_dtype
    d = cfg.d_model

    def fan_in(shape):
        return fan_in_init(generator, shape, dt, device)

    return {
        "ln1": norm_init(d, "rmsnorm", dt, device),
        "ln2": norm_init(d, "rmsnorm", dt, device),
        # time-mix interpolation coefficients (r, k, v, g, w)
        "mu": normal_init(generator, (5, d), 0.02, dt, device),
        "wr": fan_in((d, d)),
        "wk": fan_in((d, d)),
        "wv": fan_in((d, d)),
        "wg": fan_in((d, d)),
        "wo": fan_in((d, d)),
        # data-dependent decay: w = w0 + tanh(xw A) B
        "w0": normal_init(generator, (d,), 0.02, dt, device),
        "wa": fan_in((d, LORA_DIM)),
        "wb": fan_in((LORA_DIM, d)),
        "bonus": normal_init(generator, (_n_heads(cfg), cfg.wkv_head_dim),
                             0.02, torch.float32, device),
        "gn_scale": torch.ones((d,), dtype=dt, device=device),  # group norm
        # channel-mix
        "mu_c": normal_init(generator, (2, d), 0.02, dt, device),
        "ck": fan_in((d, cfg.d_ff)),
        "cr": fan_in((d, d)),
        "cv": fan_in((cfg.d_ff, d)),
    }


def layer_logical_axes(cfg: ModelConfig) -> dict:
    return {
        "ln1": {"scale": ("d_model",)},
        "ln2": {"scale": ("d_model",)},
        "mu": (None, "d_model"),
        "wr": ("d_model", "heads"),
        "wk": ("d_model", "heads"),
        "wv": ("d_model", "heads"),
        "wg": ("d_model", "heads"),
        "wo": ("heads", "d_model"),
        "w0": ("heads",),
        "wa": ("d_model", None),
        "wb": (None, "heads"),
        "bonus": (None, None),  # (H, hd) head count may not divide mesh
        "gn_scale": ("heads",),
        "mu_c": (None, "d_model"),
        "ck": ("d_model", "d_ff"),
        "cr": ("d_model", "d_model"),
        "cv": ("d_ff", "d_model"),
    }


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device | str | None = None) -> RWKV:
    """Random parameters made on ``device`` (None: the GPU) from
    ``generator``, which must live on that device."""
    device = init_device(generator, device)
    dt = cfg.torch_dtype
    embed = normal_init(generator, (cfg.vocab, cfg.d_model), 0.02, dt, device)
    layers = [init_layer(generator, cfg, device) for _ in range(cfg.n_layers)]
    return RWKV(embed, layers, norm_init(cfg.d_model, "rmsnorm", dt, device),
                fan_in_init(generator, (cfg.d_model, cfg.vocab), dt, device))


def params_logical_axes(cfg: ModelConfig) -> dict:
    def stack(ax):
        if isinstance(ax, dict):
            return {k: stack(v) for k, v in ax.items()}
        return ("layers",) + ax

    return {
        "embed": ("vocab", "d_model"),
        "layers": stack(layer_logical_axes(cfg)),
        "final_norm": {"scale": ("d_model",)},
        "lm_head": ("d_model", "vocab"),
    }


# ---------------------------------------------------------------------------
# State (decode)
# ---------------------------------------------------------------------------


def wkv_head_split(cfg: ModelConfig, rules) -> int:
    """Ranks of the ``"model"`` axis that split the WKV heads (and their
    decode state): the axis's where ``rules`` split ``heads`` and a rank's
    columns are whole heads, else 1 (no split, or part-head columns, whose
    ranks run every head and keep the whole state)."""
    m = model_split(rules, "heads")
    return m if (cfg.d_model // m) % cfg.wkv_head_dim == 0 else 1


def init_state(cfg: ModelConfig, batch: int,
               device: torch.device | str | None = None,
               rules=None) -> dict:
    """Zeros on ``device`` (None: the GPU); the WKV state of this rank's
    heads where ``rules`` split them (``wkv_head_split``)."""
    device = resolve_device(device)
    h = _n_heads(cfg) // wkv_head_split(cfg, rules)
    shift = (cfg.n_layers, batch, cfg.d_model)
    return {
        "wkv": torch.zeros(
            (cfg.n_layers, batch, h, cfg.wkv_head_dim, cfg.wkv_head_dim),
            dtype=torch.float32, device=device),
        "shift_t": torch.zeros(shift, dtype=cfg.torch_dtype, device=device),
        "shift_c": torch.zeros(shift, dtype=cfg.torch_dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def state_logical_axes(cfg: ModelConfig) -> dict:
    return {
        # the wkv head axis is a count (40) that may not divide the model
        # axis: the reference keeps the state replicated across it (H x K x
        # V a sequence); the port splits it where a rank's columns are
        # whole heads (``state_specs``)
        "wkv": ("layers", "batch", None, None, None),
        "shift_t": ("layers", "batch", "d_model"),
        "shift_c": ("layers", "batch", "d_model"),
        "pos": ("batch",),
    }


def state_specs(cfg: ModelConfig, rules, specs: dict) -> dict:
    """``specs`` (the reference's, from ``state_logical_axes``) with the
    WKV state split by head as ``rules`` split ``heads`` where a rank's
    columns are whole heads (``wkv_head_split``): each rank keeps its
    heads' state (``models.api.state_specs``)."""
    if wkv_head_split(cfg, rules) > 1:
        specs["wkv"] = (specs["wkv"][:2] + rules.spec(("heads",))
                        + (None, None))
    return specs


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _group_norm(x: torch.Tensor, scale: torch.Tensor, n_heads: int,
                cols: slice | None = None) -> torch.Tensor:
    """LayerNorm within each head's channels (RWKV's GroupNorm(H));
    ``cols``: only those channels of the result, ``scale`` being theirs."""
    b, s, d = x.shape
    xh = x.reshape(b, s, n_heads, d // n_heads).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = ((xh - mu) ** 2).mean(dim=-1, keepdim=True)
    xh = ((xh - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
    if cols is not None:
        xh = xh[..., cols]
    return (xh * scale.float()).to(x.dtype)


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x shifted right by one along seq; position 0 takes ``prev`` (decode
    state) or zeros."""
    first = prev[:, None, :] if prev is not None else torch.zeros_like(
        x[:, :1, :])
    return torch.cat([first.to(x.dtype), x[:, :-1, :]], dim=1)


def time_mix(lp, x: torch.Tensor, cfg: ModelConfig,
             wkv_state: torch.Tensor | None, shift_prev: torch.Tensor | None,
             rules):
    b, s, d = x.shape
    hd = cfg.wkv_head_dim
    split = model_split(rules, "heads") > 1
    mesh = rules.mesh if split else None
    to_ranks = (lambda t: tp.copy_to_model(t, mesh)) if split else \
        (lambda t: t)
    delta = _token_shift(x, shift_prev) - x
    mu = lp.mu
    xr = to_ranks(x + delta * mu[0])
    xk = to_ranks(x + delta * mu[1])
    xv = to_ranks(x + delta * mu[2])
    xg = to_ranks(x + delta * mu[3])
    xw = x + delta * mu[4]

    r, k, v = xr @ lp.wr, xk @ lp.wk, xv @ lp.wv
    g = xg @ lp.wg
    w_logit = lp.w0 + to_ranks(torch.tanh(xw @ lp.wa)) @ lp.wb
    w = torch.exp(-torch.exp(w_logit.float())).to(r.dtype)  # decay in (0, 1)
    # a rank's columns of the heads' output: all of them, its whole heads,
    # or (part-head columns) its slice of every head, gathered below
    cols = None
    bonus = tp.copy_to_model(lp.bonus, mesh) if split else lp.bonus
    if split and wkv_head_split(cfg, rules) == 1:
        with ranks.use_mesh(mesh):
            lo = ranks.axis_index(tp.MODEL) * r.shape[-1]
        cols = slice(lo, lo + r.shape[-1])
        r, k, v, w = (tp.gather_from_model(t, -1, mesh) for t in (r, k, v, w))
    elif split:
        with ranks.use_mesh(mesh):
            lo = ranks.axis_index(tp.MODEL) * (r.shape[-1] // hd)
        bonus = bonus[lo:lo + r.shape[-1] // hd]
    h = r.shape[-1] // hd

    def heads(t):
        return t.reshape(b, s, h, hd).transpose(1, 2)

    core = wkv6 if cfg.attention_impl == "cuda" else wkv6_ref
    out, new_state = core(heads(r), heads(k), heads(v), heads(w), bonus,
                          initial_state=wkv_state, return_state=True)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    out = _group_norm(out, lp.gn_scale, h, cols)
    out = out * F.silu(g)
    out = constrain(out, rules, ("batch", "seq", "heads"), (None, None, d))
    out = out @ lp.wo
    return (tp.reduce_from_model(out, mesh) if split else out), new_state, \
        x[:, -1, :]


def channel_mix(lp, x: torch.Tensor, shift_prev: torch.Tensor | None, rules):
    split = model_split(rules, "d_ff") > 1
    delta = _token_shift(x, shift_prev) - x
    xk = x + delta * lp.mu_c[0]
    xr = x + delta * lp.mu_c[1]
    if split:
        xk = tp.copy_to_model(xk, rules.mesh)
    kk = torch.square(F.relu(xk @ lp.ck))
    kk = constrain(kk, rules, ("batch", "seq", "d_ff"))
    kv = kk @ lp.cv
    if split:
        kv = tp.reduce_from_model(kv, rules.mesh)
    return torch.sigmoid(xr @ lp.cr) * kv, x[:, -1, :]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_fn(cfg: ModelConfig, rules, x: torch.Tensor, lp, wkv_s, sh_t,
              sh_c):
    """One layer: time mix, then channel mix.  Returns (x, the new WKV
    state and both token-shift states)."""
    xn = rms_norm(x, lp.ln1["scale"])
    tm, new_wkv, new_sh_t = time_mix(lp, xn, cfg, wkv_s, sh_t, rules)
    x = x + tm
    xn = rms_norm(x, lp.ln2["scale"])
    cm, new_sh_c = channel_mix(lp, xn, sh_c, rules)
    x = x + cm
    x = constrain(x, rules, ("batch", "seq", "d_model"))
    return x, new_wkv, new_sh_t, new_sh_c


def forward(
    params: RWKV,
    tokens: torch.Tensor,  # (B, S) int — or (B, S, D) pre-embedded
    cfg: ModelConfig,
    rules=None,
    mode: str = "train",  # train | prefill | decode
    state: dict | None = None,
    extra_embeds=None,
):
    """Logits (B, S, vocab), or (B, 1, vocab) in decode mode, and the new
    state (None without one).  Where ``rules`` split the vocab over more
    than one rank of ``"model"``, train logits are this rank's slice of the
    vocab and the others gathered whole."""
    x = _embed(params, tokens, rules) if tokens.ndim == 2 else tokens
    new = {"wkv": [], "shift_t": [], "shift_c": []}
    for i, lp in enumerate(params.layers):
        wkv_s = sh_t = sh_c = None
        if state is not None:
            wkv_s = state["wkv"][i]
            sh_t, sh_c = state["shift_t"][i], state["shift_c"][i]
        x, new_wkv, new_sh_t, new_sh_c = remat_call(
            cfg, mode, _layer_fn, cfg, rules, x, lp, wkv_s, sh_t, sh_c)
        if state is not None:
            new["wkv"].append(new_wkv)
            new["shift_t"].append(new_sh_t)
            new["shift_c"].append(new_sh_c)

    new_state = None
    if state is not None:
        new_state = {name: torch.stack(parts) for name, parts in new.items()}
        new_state["pos"] = state["pos"] + x.shape[1]
    return _logits(params, x, cfg, rules, mode), new_state


def train_loss(params: RWKV, batch: dict, cfg: ModelConfig,
               rules=None) -> torch.Tensor:
    """The forward loss.  It differentiates through the plain scan
    (``attention_impl`` "xla"), as the reference trains: the WKV6 kernel
    has no backward."""
    logits, _ = forward(params, batch["tokens"], cfg, rules, mode="train")
    return causal_lm_loss(logits, batch["tokens"], rules)
