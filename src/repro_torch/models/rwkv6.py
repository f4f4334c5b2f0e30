"""RWKV-6 "Finch": `repro.models.rwkv6` in PyTorch.

Recurrence (per head, Dk x Dv state S):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
Token shift + ddlerp mixing feed the r/k/v/g/w projections; the decay w_t
is data-dependent through a small LoRA (d -> 64 -> d).

The reference's `lax.scan` over time is a Python loop over the positions
in float32 (`_wkv_seq`), and its layer scan a loop over the stacked layer
axis, each layer recomputed in the backward pass with `rc.remat ==
"full"`.  Train/prefill carries only the (B,H,Dk,Dv) state; decode is a
one-step state update, written into the cache in place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

LORA = 64
GN_EPS = 64e-5          # the per-head group norm's epsilon


def param_defs(cfg: ModelConfig):
    d, V, n = cfg.d_model, cfg.vocab, cfg.n_layers
    H = d // cfg.rwkv_head_dim
    Dh = cfg.rwkv_head_dim
    D = lambda *s, init="normal": L.ParamDef((n, *s), (None,) * (len(s) + 1), init)
    Dm = lambda *s, lg, init="normal": L.ParamDef((n, *s), (None, *lg), init)
    att = {
        "ln": D(d, init="zeros"),
        "mu": D(5, d, init="zeros"),           # ddlerp base mix for r,k,v,g,w
        "lora_a": D(d, LORA),                   # decay lora
        "lora_b": D(LORA, d),
        "w0": D(d, init="zeros"),
        "u": D(H, Dh, init="zeros"),            # bonus
        "wr": Dm(d, d, lg=(None, "model")),
        "wk": Dm(d, d, lg=(None, "model")),
        "wv": Dm(d, d, lg=(None, "model")),
        "wg": Dm(d, d, lg=(None, "model")),
        "wo": Dm(d, d, lg=("model", None)),
        "gn": D(d, init="zeros"),               # per-channel group-norm scale
    }
    ffn = {
        "ln": D(d, init="zeros"),
        "mu": D(2, d, init="zeros"),
        "wk": Dm(d, cfg.d_ff, lg=(None, "model")),
        "wv": Dm(cfg.d_ff, d, lg=("model", None)),
        "wr": Dm(d, d, lg=(None, "model")),
    }
    return {
        "embed": L.ParamDef((V, d), ("model", None), scale=float(np.sqrt(d))),
        "layers": {"att": att, "ffn": ffn},
        "final_ln": L.ParamDef((d,), (None,), init="zeros"),
        "lm_head": L.ParamDef((d, V), (None, "model")),
    }


def _shift(x, x_prev=None):
    """Token shift: x_{t-1} (zeros/x_prev at t=0). x: (B,S,d)."""
    pad = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def _wkv_seq(r, k, v, w, u, state):
    """r,k,w: (B,S,H,Dk) v: (B,S,H,Dv) u: (H,Dk) state: (B,H,Dk,Dv).

    Returns y: (B,S,H,Dv), final state.  A loop over time in f32."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,Dk,Dv)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               S + u[..., None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S


def _time_mix(cfg, p, x, x_prev, state, rc):
    cdt = getattr(torch, rc.compute_dtype)
    B, S, d = x.shape
    H, Dh = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    hs = _shift(h, x_prev)
    mu = p["mu"].to(cdt)
    xr, xk, xv, xg, xw = (_mix(h, hs, mu[i]) for i in range(5))
    r = (xr @ p["wr"].to(cdt)).reshape(B, S, H, Dh)
    k = (xk @ p["wk"].to(cdt)).reshape(B, S, H, Dh)
    v = (xv @ p["wv"].to(cdt)).reshape(B, S, H, Dh)
    g = F.silu(xg @ p["wg"].to(cdt))
    dw = torch.tanh(xw @ p["lora_a"].to(cdt)) @ p["lora_b"].to(cdt)
    w = torch.exp(-torch.exp(p["w0"].float() + dw.float())).reshape(
        B, S, H, Dh)
    y, state = _wkv_seq(r, k, v, w, p["u"].float(), state)
    # group norm per head
    y = y.to(cdt)
    y = y * torch.rsqrt(torch.mean(torch.square(y.float()), dim=-1,
                                   keepdim=True) + GN_EPS).to(cdt)
    y = y.reshape(B, S, d) * (1.0 + p["gn"].to(cdt))
    out = (y * g) @ p["wo"].to(cdt)
    return x + out, h[:, -1], state


def _channel_mix(cfg, p, x, x_prev, rc):
    cdt = getattr(torch, rc.compute_dtype)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    hs = _shift(h, x_prev)
    mu = p["mu"].to(cdt)
    xk, xr = _mix(h, hs, mu[0]), _mix(h, hs, mu[1])
    k = torch.square(F.relu(xk @ p["wk"].to(cdt)))
    v = k @ p["wv"].to(cdt)
    r = torch.sigmoid(xr @ p["wr"].to(cdt))
    return x + r * v, h[:, -1]


def forward(cfg: ModelConfig, params, batch, rc, return_cache=False):
    """Returns (x, 0, cache, None, 0): the cache holds each layer's last
    normalised inputs ("x_att", "x_ffn") and wkv state ("state")."""
    cdt = getattr(torch, rc.compute_dtype)
    x = params["embed"][batch["tokens"]].to(cdt)
    B, S, d = x.shape
    H, Dh = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    state0 = torch.zeros((B, H, Dh, Dh), dtype=torch.float32,
                         device=x.device)

    def body(x, pl):
        x, xa, st = _time_mix(cfg, pl["att"], x, None, state0, rc)
        x, xf = _channel_mix(cfg, pl["ffn"], x, None, rc)
        return x, xa, xf, st

    remat = rc.remat == "full" and torch.is_grad_enabled()
    kept = []
    for i in range(cfg.n_layers):
        pl = L.tree_map(lambda a: a[i], params["layers"])
        out = (checkpoint(body, x, pl, use_reentrant=False) if remat
               else body(x, pl))
        x = out[0]
        if return_cache:
            kept.append(out[1:])
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    cache = None
    if return_cache:
        xa, xf, st = (torch.stack(t) for t in zip(*kept))
        cache = {"x_att": xa, "x_ffn": xf, "state": st}
    return x, 0, cache, None, torch.zeros((), dtype=torch.float32,
                                          device=x.device)


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, dtype):
    """{name: (shape, dtype)}: the state stays f32 whatever `dtype`."""
    d, n = cfg.d_model, cfg.n_layers
    H, Dh = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return {"state": ((n, batch_size, H, Dh, Dh), torch.float32),
            "x_att": ((n, batch_size, d), dtype),
            "x_ffn": ((n, batch_size, d), dtype)}


def decode(cfg: ModelConfig, params, cache, token, pos: int, rc):
    """One-token step: each layer's state and shifted inputs advance in
    place.  Returns (logits (B,1,V), cache)."""
    cdt = getattr(torch, rc.compute_dtype)
    x = params["embed"][token].to(cdt)      # (B,1,d)
    for i in range(cfg.n_layers):
        pl = L.tree_map(lambda a: a[i], params["layers"])
        x, xa, st = _time_mix(cfg, pl["att"], x, cache["x_att"][i],
                              cache["state"][i], rc)
        x, xf = _channel_mix(cfg, pl["ffn"], x, cache["x_ffn"][i], rc)
        cache["x_att"][i] = xa
        cache["x_ffn"][i] = xf
        cache["state"][i] = st
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return x @ params["lm_head"].to(cdt), cache
