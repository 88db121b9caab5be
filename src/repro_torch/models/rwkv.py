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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import constrain
from repro_torch.kernels.rwkv6 import wkv6, wkv6_ref

from .config import ModelConfig
from .layers import (causal_lm_loss, fan_in_init, init_device, norm_init,
                     normal_init, remat_call, rms_norm)
from .layers import remat_policy_of  # noqa: F401  (public, as the reference's)
from .transformer import Transformer

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


def init_state(cfg: ModelConfig, batch: int,
               device: torch.device | str | None = None) -> dict:
    """Zeros on ``device`` (None: the GPU)."""
    device = resolve_device(device)
    h = _n_heads(cfg)
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
        # axis: the state stays replicated across it (H x K x V a sequence)
        "wkv": ("layers", "batch", None, None, None),
        "shift_t": ("layers", "batch", "d_model"),
        "shift_c": ("layers", "batch", "d_model"),
        "pos": ("batch",),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _group_norm(x: torch.Tensor, scale: torch.Tensor,
                n_heads: int) -> torch.Tensor:
    """LayerNorm within each head's channels (RWKV's GroupNorm(H))."""
    b, s, d = x.shape
    xh = x.reshape(b, s, n_heads, d // n_heads).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = ((xh - mu) ** 2).mean(dim=-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + 1e-5)
    return (xh.reshape(b, s, d) * scale.float()).to(x.dtype)


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
    h = _n_heads(cfg)
    hd = cfg.wkv_head_dim
    delta = _token_shift(x, shift_prev) - x
    mu = lp.mu
    xr = x + delta * mu[0]
    xk = x + delta * mu[1]
    xv = x + delta * mu[2]
    xg = x + delta * mu[3]
    xw = x + delta * mu[4]

    r = (xr @ lp.wr).reshape(b, s, h, hd).transpose(1, 2)
    k = (xk @ lp.wk).reshape(b, s, h, hd).transpose(1, 2)
    v = (xv @ lp.wv).reshape(b, s, h, hd).transpose(1, 2)
    g = xg @ lp.wg
    w_logit = lp.w0 + torch.tanh(xw @ lp.wa) @ lp.wb
    w = torch.exp(-torch.exp(w_logit.float()))  # decay in (0, 1)
    w = w.reshape(b, s, h, hd).transpose(1, 2)

    core = wkv6 if cfg.attention_impl == "cuda" else wkv6_ref
    out, new_state = core(r, k, v, w.to(r.dtype), lp.bonus,
                          initial_state=wkv_state, return_state=True)
    out = out.transpose(1, 2).reshape(b, s, d)
    out = _group_norm(out, lp.gn_scale, h)
    out = out * F.silu(g)
    out = constrain(out, rules, ("batch", "seq", "heads"))
    return out @ lp.wo, new_state, x[:, -1, :]


def channel_mix(lp, x: torch.Tensor, shift_prev: torch.Tensor | None, rules):
    delta = _token_shift(x, shift_prev) - x
    xk = x + delta * lp.mu_c[0]
    xr = x + delta * lp.mu_c[1]
    kk = torch.square(F.relu(xk @ lp.ck))
    kk = constrain(kk, rules, ("batch", "seq", "d_ff"))
    return torch.sigmoid(xr @ lp.cr) * (kk @ lp.cv), x[:, -1, :]


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
    state (None without one)."""
    x = params.embed[tokens.long()] if tokens.ndim == 2 else tokens
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

    x = rms_norm(x, params.final_norm["scale"])
    if mode == "decode":
        x = x[:, -1:, :]
    logits = x @ params.lm_head
    logits = constrain(logits, rules, ("batch", "seq", "vocab"))
    return logits, new_state


def train_loss(params: RWKV, batch: dict, cfg: ModelConfig,
               rules=None) -> torch.Tensor:
    """The forward loss.  It differentiates through the plain scan
    (``attention_impl`` "xla"), as the reference trains: the WKV6 kernel
    has no backward."""
    logits, _ = forward(params, batch["tokens"], cfg, rules, mode="train")
    return causal_lm_loss(logits, batch["tokens"])
