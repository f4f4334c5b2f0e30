"""Plain forward passes of the benchmark's models over one prompt, in the
precision of `prec` (`ref.F32` or the control `ref.FP8`), layer by layer,
from the weights as the benchmark made them (any dtype; each product
takes them in its own precision).

Each returns (logits, cache): the float32 logits of the last position
(V,), or of every position (S, V) with `every=True`; the cache holds what a prefill hands to decoding, per layer, in float32:
the keys (after RoPE) and values of each attention layer, and for a
Mamba2 block its conv input window and its SSM state.

Semantics, as the configuration files state them (with the port's
departures from the published models, listed there): RMSNorm scaling by
1 + w; RoPE on split halves; causal GQA softmax attention; SwiGLU
experts behind a float32 softmax router whose top-k weights are
renormalised, each expert taking at most C assignments in token order
(C = max(8, 8 * ceil(int(T k / E * capacity_factor) / 8))), the rest
dropped; Mamba2 blocks with a causal depthwise conv, SiLU, the SSD
recurrence h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t + D x_t,
gated by SiLU(z) and RMS-normed; a shared attention + gated-GELU (tanh)
block after every `group` Mamba2 blocks.  The SSD is evaluated in its
quadratic (attention-like) form, its running sums of dt a in float64,
not chunked.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Q_ROWS = 512          # query rows a step of the attention / SSD


def rms(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * \
        (1.0 + w.float())


def rope(x, theta):
    """x (S, heads, D), positions 0..S-1."""
    S, _, D = x.shape
    half = D // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, prec):
    """Causal softmax attention; q (S, H, D), k/v (S, Hkv, D)."""
    q, k, v = prec.act(q), prec.act(k), prec.act(v)
    S, H, D = q.shape
    Hkv = k.shape[1]
    qg = q.view(S, Hkv, H // Hkv, D)
    out = torch.empty(S, H, D, device=q.device)
    pos = torch.arange(S, device=q.device)
    for t0 in range(0, S, Q_ROWS):
        t1 = min(S, t0 + Q_ROWS)
        s = torch.einsum("qhgd,khd->hgqk", qg[t0:t1], k[:t1]) / math.sqrt(D)
        s = s.masked_fill(pos[None, :t1] > pos[t0:t1, None], float("-inf"))
        p = torch.softmax(s, -1)
        out[t0:t1] = torch.einsum("hgqk,khd->qhgd", p, v[:t1]).reshape(
            t1 - t0, H, D)
    return out


def attn_layer(x, a, cfg, H, Hkv, Dh, prec):
    """x + attention(x); returns (x, k, v)."""
    S = x.shape[0]
    h = rms(x, a["ln"], cfg["rms_norm_eps"])
    q = rope(prec.mm(h, a["wq"]).view(S, H, Dh), cfg["rope_theta"])
    k = rope(prec.mm(h, a["wk"]).view(S, Hkv, Dh), cfg["rope_theta"])
    v = prec.mm(h, a["wv"]).view(S, Hkv, Dh)
    o = attention(q, k, v, prec)
    return x + prec.mm(o.reshape(S, H * Dh), a["wo"]), k, v


def capacity(T, k, E, cf):
    c = int(T * k / E * cf)
    return max(8, -(-c // 8) * 8)


def moe(h, m, cfg, prec):
    """(y, aux) over the tokens h (T, d): aux = E sum_e mean_t(p_te)
    * share of tokens whose first choice is e (no gradient)."""
    T, d = h.shape
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(h @ m["router"].float(), -1)
    top_p, top_e = torch.topk(probs, k, -1)
    first = torch.zeros(E, device=h.device).index_add_(
        0, top_e[:, 0], torch.ones(T, device=h.device)) / T
    aux = E * (probs.mean(0) * first).sum()
    top_p = top_p / top_p.sum(-1, keepdim=True)
    C = capacity(T, k, E, cfg["capacity_factor"])
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    y = torch.zeros_like(h)
    for e in range(E):
        idx = torch.nonzero(flat_e == e)[:C, 0]
        tok = idx // k
        xe = h[tok]
        g = prec.mm(xe, m["wg"][e])
        u = prec.mm(xe, m["wu"][e])
        out = prec.mm(F.silu(g) * u, m["wd"][e])
        y = y.index_add(0, tok, out * flat_p[idx, None])
    return y, aux


def _layer(stacked, *idx):
    return {k: v[idx] for k, v in stacked.items()}


def phimoe_hidden(W, cfg, tokens, prec):
    """Hidden states (B, S, d) before the final norm over token rows
    (B, S), the experts' capacity counted over all B S tokens, the sum of
    the layers' aux, and the cache of row 0."""
    d, H, Hkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                 cfg["num_key_value_heads"])
    Dh = d // H
    B, S = tokens.shape
    x = W["embed"][tokens.long()].float()
    cache = {"k": [], "v": []}
    aux = 0.0
    for i in range(cfg["num_hidden_layers"]):
        a = _layer(W["layers"]["attn"], i)
        rows = [attn_layer(x[b], a, cfg, H, Hkv, Dh, prec) for b in range(B)]
        x = torch.stack([r[0] for r in rows])
        cache["k"].append(rows[0][1])
        cache["v"].append(rows[0][2])
        m = _layer(W["layers"]["mlp"], i)
        y, a_i = moe(rms(x, m["ln"], cfg["rms_norm_eps"]).reshape(B * S, d),
                     m, cfg, prec)
        x = x + y.reshape(B, S, d)
        aux = aux + a_i
    return x, aux, cache


def phimoe(W, cfg, tokens, prec, every=False):
    x, _, cache = phimoe_hidden(W, cfg, tokens[None], prec)
    return _logits(W, cfg, x[0], prec, every), cache


def _logits(W, cfg, x, prec, every):
    x = rms(x if every else x[-1:], W["final_ln"], cfg["rms_norm_eps"])
    logits = prec.mm(x, W["lm_head"])
    return logits if every else logits[0]


def ssd(xh, Bm, Cm, dt, a):
    """y (S, H, P) and the final state (H, N, P) of the SSD recurrence,
    from its quadratic form y_t = sum_{s<=t} (C_t . B_s)
    exp(cum_t - cum_s) dt_s x_s, cum the running sum of dt a (float64)."""
    S, H, P = xh.shape
    cum = torch.cumsum(dt.double() * a.double(), 0)          # (S, H)
    y = torch.empty(S, H, P, device=xh.device)
    pos = torch.arange(S, device=xh.device)
    for t0 in range(0, S, Q_ROWS // 2):
        t1 = min(S, t0 + Q_ROWS // 2)
        g = Cm[t0:t1] @ Bm[:t1].T                            # (Q, s)
        dec = torch.exp((cum[t0:t1, None] - cum[None, :t1]).float())
        dec = dec.masked_fill((pos[None, :t1] > pos[t0:t1, None])[..., None],
                              0.0)
        mix = g[..., None] * dec * dt[None, :t1]             # (Q, s, H)
        y[t0:t1] = torch.einsum("qsh,shp->qhp", mix, xh[:t1])
    w = (torch.exp(cum[-1:] - cum).float() * dt)             # (S, H)
    state = torch.einsum("sh,sn,shp->hnp", w, Bm, xh)
    return y, state


def mamba(x, p, cfg, prec):
    """x + Mamba2(x); returns (x, conv window (W-1, conv_dim), state)."""
    S, d = x.shape
    d_in = cfg["mamba_expand"] * d
    P, N, Wc = cfg["mamba_headdim"], cfg["mamba_d_state"], cfg["mamba_d_conv"]
    H = d_in // P
    conv_dim = d_in + 2 * N
    zx = prec.mm(rms(x, p["ln"], cfg["rms_norm_eps"]), p["in_proj"])
    z, xbc, dt_raw = zx[:, :d_in], zx[:, d_in:d_in + conv_dim], \
        zx[:, d_in + conv_dim:]
    xp = torch.cat([torch.zeros(Wc - 1, conv_dim, device=x.device), xbc])
    w = p["conv_w"].float()
    conv = sum(xp[i:i + S] * w[i] for i in range(Wc))
    window = xp[-(Wc - 1):]
    xbc = F.silu(conv)
    xh = xbc[:, :d_in].reshape(S, H, P)
    Bm, Cm = xbc[:, d_in:d_in + N], xbc[:, d_in + N:]
    dt = F.softplus(dt_raw + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    y, state = ssd(xh, Bm, Cm, dt, a)
    y = y + p["skip_d"].float()[None, :, None] * xh
    y = y.reshape(S, d_in) * F.silu(z)
    y = rms(y, p["gn"], cfg["rms_norm_eps"])
    return x + prec.mm(y, p["out_proj"]), window, state


def zamba2(W, cfg, tokens, prec, every=False):
    d, H, Hkv, Dh = (cfg["hidden_size"], cfg["num_attention_heads"],
                     cfg["num_key_value_heads"], cfg["kv_channels"])
    group = cfg["port"]["group"]
    apps = len(cfg["hybrid_layer_ids"])
    tail = cfg["num_hidden_layers"] - apps * group
    sa = {k: v[0] for k, v in W["shared_attn"]["attn"].items()}
    sm = {k: v[0] for k, v in W["shared_attn"]["mlp"].items()}
    x = W["embed"][tokens.long()].float()
    cache = {"conv": [], "state": [], "k": [], "v": []}

    def block(x, p):
        x, window, state = mamba(x, p, cfg, prec)
        cache["conv"].append(window)
        cache["state"].append(state)
        return x

    for g in range(apps):
        for j in range(group):
            x = block(x, _layer(W["mamba_groups"], g, j))
        x, k, v = attn_layer(x, sa, cfg, H, Hkv, Dh, prec)
        cache["k"].append(k)
        cache["v"].append(v)
        h = rms(x, sm["ln"], cfg["rms_norm_eps"])
        gate = F.gelu(prec.mm(h, sm["wg"]), approximate="tanh")
        x = x + prec.mm(gate * prec.mm(h, sm["wu"]), sm["wd"])
    for j in range(tail):
        x = block(x, _layer(W["mamba_tail"], j))
    return _logits(W, cfg, x, prec, every), cache


FORWARD = {"phimoe": phimoe, "zamba2": zamba2}
