"""The plain forward pass of Granite 4.0-H (`granitemoehybrid`) over one
prompt, in the precision of `prec` (`ref.F32` or the control `ref.FP8`),
layer by layer, from the weights as the benchmark made them (laid out as
the port's `granite_hybrid.param_defs`: "mamba_layers" and "attn_layers"
stacked apart, each a mixer and its FFN).

Semantics, from config.json's keys and the published layer equations:

    x <- embed(tokens) * embedding_multiplier
    x <- x + residual_multiplier * mixer(rms(x))      per layer_types
    h  = rms(x)
    x <- x + residual_multiplier * (sum_top-k g_e SwiGLU_e(h) + SwiGLU_s(h))
    logits = rms(x) @ embed^T / logits_scaling       (tied embeddings)

Mamba2 mixer: in_proj to (z, xBC, dt), a causal depthwise conv with bias
over xBC and SiLU, the SSD recurrence (`ssd`, as `models.ssd`: its
quadratic form in row blocks, the running sums of dt a in float64),
y + D x gated by SiLU(z) and RMS-normed, out_proj.  Attention mixer:
GQA with no position embedding (`position_embedding_type` "nope"),
softmax scale `attention_multiplier`, causal, in row blocks.  Router: `models.moe`, a
float32 softmax whose top-k weights are renormalised (equal to the
published softmax over the top-k logits), each expert taking at most C
assignments in token order; the shared expert over every token.

Departures of the port, as the configuration file lists them: RMSNorm
scaling by 1 + w; the capacity bound (the published model is dropless).

Returns (logits, cache) as `models.FORWARD`'s functions do: the cache
holds, per layer in layer order within each kind, each Mamba2 layer's
conv input window ("conv") and SSM state ("state"), and each attention
layer's keys and values ("k", "v").
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from chipbench.ref import models as M

SSD_ROWS = 64         # query rows a step of the SSD's quadratic form


def ssd(xh, Bm, Cm, dt, a):
    """`models.ssd` in steps of SSD_ROWS query rows: y (S, H, P) and the
    final state (H, N, P) from y_t = sum_{s<=t} (C_t . B_s)
    exp(cum_t - cum_s) dt_s x_s, cum the running sum of dt a (float64).
    A step's (rows, S, H) terms take 256 MB at H = 128 and S = 8192,
    beside 64 GB of weights."""
    S, H, P = xh.shape
    cum = torch.cumsum(dt.double() * a.double(), 0)          # (S, H)
    y = torch.empty(S, H, P, device=xh.device)
    pos = torch.arange(S, device=xh.device)
    for t0 in range(0, S, SSD_ROWS):
        t1 = min(S, t0 + SSD_ROWS)
        g = Cm[t0:t1] @ Bm[:t1].T                            # (Q, s)
        dec = torch.exp((cum[t0:t1, None] - cum[None, :t1]).float())
        dec = dec.masked_fill((pos[None, :t1] > pos[t0:t1, None])[..., None],
                              0.0)
        mix = g[..., None] * dec * dt[None, :t1]             # (Q, s, H)
        y[t0:t1] = torch.einsum("qsh,shp->qhp", mix, xh[:t1])
    w = (torch.exp(cum[-1:] - cum).float() * dt)             # (S, H)
    state = torch.einsum("sh,sn,shp->hnp", w, Bm, xh)
    return y, state


def attention(q, k, v, scale, prec):
    """Causal softmax attention with no position embedding; q (S, H, D),
    k/v (S, Hkv, D)."""
    q, k, v = prec.act(q), prec.act(k), prec.act(v)
    S, H, D = q.shape
    Hkv = k.shape[1]
    qg = q.view(S, Hkv, H // Hkv, D)
    out = torch.empty(S, H, D, device=q.device)
    pos = torch.arange(S, device=q.device)
    for t0 in range(0, S, M.Q_ROWS):
        t1 = min(S, t0 + M.Q_ROWS)
        s = torch.einsum("qhgd,khd->hgqk", qg[t0:t1], k[:t1]) * scale
        s = s.masked_fill(pos[None, :t1] > pos[t0:t1, None], float("-inf"))
        out[t0:t1] = torch.einsum("hgqk,khd->qhgd", torch.softmax(s, -1),
                                  v[:t1]).reshape(t1 - t0, H, D)
    return out


def attn_mixer(h, a, cfg, prec):
    """(mixer output, k, v) of the normed input h (S, d)."""
    S, d = h.shape
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = d // H
    q = prec.mm(h, a["wq"]).view(S, H, D)
    k = prec.mm(h, a["wk"]).view(S, Hkv, D)
    v = prec.mm(h, a["wv"]).view(S, Hkv, D)
    o = attention(q, k, v, cfg["attention_multiplier"], prec)
    return prec.mm(o.reshape(S, H * D), a["wo"]), k, v


def mamba_mixer(h, p, cfg, prec):
    """(mixer output, conv window (W-1, conv_dim), state (H, N, P)) of the
    normed input h (S, d)."""
    S, d = h.shape
    d_in = cfg["mamba_expand"] * d
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N, Wc = cfg["mamba_d_state"], cfg["mamba_d_conv"]
    GN = cfg["mamba_n_groups"] * N
    conv_dim = d_in + 2 * GN
    zx = prec.mm(h, p["in_proj"])
    z, xbc, dt_raw = zx[:, :d_in], zx[:, d_in:d_in + conv_dim], \
        zx[:, d_in + conv_dim:]
    xp = torch.cat([torch.zeros(Wc - 1, conv_dim, device=h.device), xbc])
    w = p["conv_w"].float()
    conv = sum(xp[i:i + S] * w[i] for i in range(Wc))
    if cfg["mamba_conv_bias"]:
        conv = conv + p["conv_b"].float()
    xbc = F.silu(conv)
    xh = xbc[:, :d_in].reshape(S, H, P)
    Bm, Cm = xbc[:, d_in:d_in + GN], xbc[:, d_in + GN:]
    dt = F.softplus(dt_raw + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    y, state = ssd(xh, Bm, Cm, dt, a)
    y = y + p["skip_d"].float()[None, :, None] * xh
    y = M.rms(y.reshape(S, d_in) * F.silu(z), p["gn"], cfg["rms_norm_eps"])
    # the window copied out: a view would keep all of xp alive per layer
    return prec.mm(y, p["out_proj"]), xp[-(Wc - 1):].clone(), state


def ffn(h, m, cfg, prec):
    """The routed experts' sum and the shared expert's output over h."""
    y, _ = M.moe(h, m, cfg, prec)
    g = prec.mm(h, m["shared_wg"])
    u = prec.mm(h, m["shared_wu"])
    return y + prec.mm(F.silu(g) * u, m["shared_wd"])


def forward(W, cfg, tokens, prec, every=False):
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    x = W["embed"][tokens.long()].float() * cfg["embedding_multiplier"]
    cache = {"conv": [], "state": [], "k": [], "v": []}
    seen = {"mamba": 0, "attention": 0}
    for kind in cfg["layer_types"]:
        j = seen[kind]
        seen[kind] += 1
        if kind == "mamba":
            p = M._layer(W["mamba_layers"]["mixer"], j)
            m = M._layer(W["mamba_layers"]["mlp"], j)
            out, window, state = mamba_mixer(M.rms(x, p["ln"], eps), p, cfg,
                                             prec)
            cache["conv"].append(window)
            cache["state"].append(state)
        else:
            a = M._layer(W["attn_layers"]["attn"], j)
            m = M._layer(W["attn_layers"]["mlp"], j)
            out, k, v = attn_mixer(M.rms(x, a["ln"], eps), a, cfg, prec)
            cache["k"].append(k)
            cache["v"].append(v)
        x = x + r * out
        x = x + r * ffn(M.rms(x, m["ln"], eps), m, cfg, prec)
    x = M.rms(x if every else x[-1:], W["final_ln"], eps)
    logits = prec.mm(x, W["embed"].T) / cfg["logits_scaling"]
    return (logits if every else logits[0]), cache
