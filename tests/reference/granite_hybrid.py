"""A plain reference of Granite 4.0-H (`granitemoehybrid`), for the tests:
one prompt, float32 (TF32 off), no cache, no batching and no kernel, from
the published layer equations

    x <- embed(tokens) * embedding_multiplier
    x <- x + residual_multiplier * mixer(rms(x))       Mamba2 or attention
    h  = rms(x)
    x <- x + residual_multiplier * (sum_top-k g_e SwiGLU_e(h) + SwiGLU_s(h))
    logits = rms(x) @ embed^T / logits_scaling

Mamba2: in_proj to (z, xBC, dt); a causal depthwise conv with bias over
xBC, SiLU; the SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
y_t = C_t h_t + D x_t, run position by position, dt = softplus(dt +
dt_bias), A = -exp(a_log); y * SiLU(z), RMS-normed, out_proj.  Attention:
GQA, no position embedding, softmax scale `attn_scale`.  Router: the
softmax of the top-k logits.

Departures of the port, kept here: RMSNorm scales by 1 + w; each expert
takes at most C = max(8, 8 ceil(int(T k / E capacity_factor) / 8))
assignments in token order and drops the rest (the published model is
dropless).

Imports nothing of the port: `cfg` is read by attribute (a ModelConfig
or anything with the same names) and the weights are a nested dict of
tensors keyed as the port's `granite_hybrid.param_defs`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * \
        (1.0 + w.float())


def _at(stack, i):
    return {k: (_at(v, i) if isinstance(v, dict) else v[i].float())
            for k, v in stack.items()}


def mamba(x, p, cfg):
    """Returns (mixer output, conv window (W-1, conv_dim), state (H, N,
    P))."""
    S, d = x.shape
    d_in, N, P, Wc = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim, \
        cfg.conv_width
    H = d_in // P
    conv_dim = d_in + 2 * N
    zx = x @ p["in_proj"]
    z, xbc, dt = zx[:, :d_in], zx[:, d_in:d_in + conv_dim], \
        zx[:, d_in + conv_dim:]
    xp = torch.cat([torch.zeros(Wc - 1, conv_dim), xbc])
    conv = sum(xp[i:i + S] * p["conv_w"][i] for i in range(Wc))
    if "conv_b" in p:
        conv = conv + p["conv_b"]
    u = F.silu(conv)
    xh = u[:, :d_in].reshape(S, H, P)
    Bm, Cm = u[:, d_in:d_in + N], u[:, d_in + N:]
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    h = torch.zeros(H, N, P)
    y = torch.empty(S, H, P)
    for t in range(S):
        h = torch.exp(dt[t] * a)[:, None, None] * h + \
            dt[t][:, None, None] * Bm[t][None, :, None] * xh[t][:, None, :]
        y[t] = torch.einsum("n,hnp->hp", Cm[t], h)
    y = y + p["skip_d"][None, :, None] * xh
    y = y.reshape(S, d_in) * F.silu(z)
    y = rms(y, p["gn"], cfg.norm_eps)
    return y @ p["out_proj"], xp[-(Wc - 1):], h


def attention(x, p, cfg):
    """Returns (mixer output, k (S, Hkv, D), v (S, Hkv, D))."""
    S = x.shape[0]
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).view(S, H, D)
    k = (x @ p["wk"]).view(S, Hkv, D)
    v = (x @ p["wv"]).view(S, Hkv, D)
    kk = k.repeat_interleave(H // Hkv, dim=1)
    vv = v.repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, kk) * scale_of(cfg)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                      float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), vv)
    return o.reshape(S, H * D) @ p["wo"], k, v


def capacity(T, k, E, cf):
    c = int(T * k / E * cf)
    return max(8, -(-c // 8) * 8)


def swiglu(h, wg, wu, wd):
    return (F.silu(h @ wg) * (h @ wu)) @ wd


def moe(h, p, cfg):
    T = h.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    top_l, top_e = torch.topk(h @ p["router"], k, -1)
    gate = torch.softmax(top_l, -1)
    C = capacity(T, k, E, cfg.capacity_factor)
    flat_e, flat_g = top_e.reshape(-1), gate.reshape(-1)
    y = torch.zeros_like(h)
    for e in range(E):
        idx = torch.nonzero(flat_e == e)[:C, 0]
        tok = idx // k
        out = swiglu(h[tok], p["wg"][e], p["wu"][e], p["wd"][e])
        y = y.index_add(0, tok, out * flat_g[idx, None])
    if "shared_wg" in p:
        y = y + swiglu(h, p["shared_wg"], p["shared_wu"], p["shared_wd"])
    return y


def forward(W, cfg, tokens):
    """Logits (S, V) at every position of `tokens` (S,), and the cache a
    prefill hands on: per layer, in layer order within each kind, "conv"
    and "state" of the Mamba2 layers, "k" and "v" of the attention
    layers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps, r = cfg.norm_eps, cfg.residual_mult
    x = W["embed"][tokens.long()].float() * cfg.embed_mult
    cache = {"conv": [], "state": [], "k": [], "v": []}
    seen = {"mamba": 0, "attention": 0}
    for kind in cfg.layer_types:
        stack = W["mamba_layers" if kind == "mamba" else "attn_layers"]
        lp = _at(stack, seen[kind])
        seen[kind] += 1
        if kind == "mamba":
            out, window, state = mamba(rms(x, lp["mixer"]["ln"], eps),
                                       lp["mixer"], cfg)
            cache["conv"].append(window)
            cache["state"].append(state)
        else:
            out, k, v = attention(rms(x, lp["attn"]["ln"], eps), lp["attn"],
                                  cfg)
            cache["k"].append(k)
            cache["v"].append(v)
        x = x + r * out
        x = x + r * moe(rms(x, lp["mlp"]["ln"], eps), lp["mlp"], cfg)
    x = rms(x, W["final_ln"].float(), eps)
    return x @ W["embed"].float().T / cfg.logits_scale, cache


def scale_of(cfg) -> float:
    """The softmax scale the configuration asks for."""
    return cfg.attn_scale or 1.0 / math.sqrt(cfg.head_dim)
