"""Decoder-only transformer: the dense family of `repro.models.transformer`.

Covers yi-9b, gemma3-12b (5:1 local:global), qwen3-4b (qk_norm) and
qwen2-7b (qkv bias).  Parameters are a nested dict of tensors keyed like
`param_defs`, each layer's weights stacked on a leading axis, so the two
packages exchange them (`models/convert.py`).  The reference's layer scan
is a Python loop over that axis; with `rc.remat == "full"` each layer
is recomputed in the backward pass (`torch.utils.checkpoint`), as the
reference's `_maybe_remat` does.  Each layer gets its window as an int;
the flash kernel is taken only when every layer has the same window, as
in the reference, where a per-layer window is traced.  The kernel is
forward only, as the reference's is: attention that needs a gradient
raises on the flash path.

Not ported yet (they raise NotImplementedError): MoE layers, the
encoder-decoder and patch-prefix models, and the ring-buffered windowed
decode cache (ROADMAP Queue 1 items 3 and 4).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_NOT_PORTED = {
    "moe": "MoE layers are not ported yet (ROADMAP Queue 1 item 3)",
    "enc_dec": "encoder-decoder models are not ported yet (ROADMAP Queue 1 "
               "item 4)",
    "prefix": "patch-prefix models are not ported yet (ROADMAP Queue 1 "
              "item 4)",
    "windowed": "the ring-buffered windowed decode cache (decode_windowed) "
                "is not ported yet (ROADMAP Queue 1 item 4)",
}


def _dense_only(cfg: ModelConfig):
    if cfg.is_moe:
        raise NotImplementedError(_NOT_PORTED["moe"])
    if cfg.enc_layers:
        raise NotImplementedError(_NOT_PORTED["enc_dec"])
    if cfg.n_patches:
        raise NotImplementedError(_NOT_PORTED["prefix"])


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ----------------------------------------------------------------- params

def _attn_defs(cfg: ModelConfig, n: int, cross: bool = False):
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    D = lambda *s, lg, init="normal": L.ParamDef((n, *s), (None, *lg), init)
    p = {
        "ln": D(d, lg=(None,), init="zeros"),
        "wq": D(d, H * Dh, lg=(None, "model")),
        "wk": D(d, Hkv * Dh, lg=(None, "model")),
        "wv": D(d, Hkv * Dh, lg=(None, "model")),
        "wo": D(H * Dh, d, lg=("model", None)),
    }
    if cfg.qkv_bias and not cross:
        p |= {"bq": D(H * Dh, lg=("model",), init="zeros"),
              "bk": D(Hkv * Dh, lg=("model",), init="zeros"),
              "bv": D(Hkv * Dh, lg=("model",), init="zeros")}
    if cfg.qk_norm and not cross:
        p |= {"qn": D(Dh, lg=(None,), init="zeros"),
              "kn": D(Dh, lg=(None,), init="zeros")}
    return p


def _mlp_defs(cfg: ModelConfig, n: int):
    d = cfg.d_model
    D = lambda *s, lg, init="normal": L.ParamDef((n, *s), (None, *lg), init)
    if cfg.is_moe:
        E, f = cfg.n_experts, cfg.d_ff_expert
        return {
            "ln": D(d, lg=(None,), init="zeros"),
            "router": D(d, E, lg=(None, None)),
            "wg": D(E, d, f, lg=("model", None, None)),
            "wu": D(E, d, f, lg=("model", None, None)),
            "wd": D(E, f, d, lg=("model", None, None)),
        }
    f = cfg.d_ff
    return {
        "ln": D(d, lg=(None,), init="zeros"),
        "wg": D(d, f, lg=(None, "model")),
        "wu": D(d, f, lg=(None, "model")),
        "wd": D(f, d, lg=("model", None)),
    }


def param_defs(cfg: ModelConfig):
    """The reference's parameter tree (MoE, encoder and patch leaves
    included, so parameter counts agree), as ParamDefs."""
    d, V = cfg.d_model, cfg.vocab
    n = cfg.n_layers
    defs = {
        "embed": L.ParamDef((V, d), ("model", None), scale=float(np.sqrt(d))),
        "final_ln": L.ParamDef((d,), (None,), init="zeros"),
        "layers": {"attn": _attn_defs(cfg, n), "mlp": _mlp_defs(cfg, n)},
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = L.ParamDef((d, V), (None, "model"))
    if cfg.enc_layers:
        ne = cfg.enc_layers
        defs["enc_layers"] = {"attn": _attn_defs(cfg, ne),
                              "mlp": _mlp_defs(cfg, ne)}
        defs["enc_final_ln"] = L.ParamDef((d,), (None,), init="zeros")
        defs["layers"]["xattn"] = _attn_defs(cfg, n, cross=True)
        defs["dec_pos"] = L.ParamDef((32768, d), (None, None), init="zeros")
    if cfg.n_patches:
        defs["patch_proj"] = L.ParamDef((d, d), (None, "model"))
    return defs


def windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = global/full)."""
    w = np.zeros(cfg.n_layers, np.int32)
    if cfg.sliding_window and cfg.global_every:
        for i in range(cfg.n_layers):
            if (i + 1) % cfg.global_every != 0:
                w[i] = cfg.sliding_window
    elif cfg.sliding_window:
        w[:] = cfg.sliding_window
    return w


def _layer(stacked, i: int):
    """Layer i's parameters: views into the stacked tensors."""
    return L.tree_map(lambda a: a[i], stacked)


# ----------------------------------------------------------------- blocks

def _qkv(cfg, p, x, cdt):
    B, S, d = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    q = h @ p["wq"].to(cdt)
    k = h @ p["wk"].to(cdt)
    v = h @ p["wv"].to(cdt)
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    if "qn" in p:
        q = L.rms_norm(q, p["qn"], cfg.norm_eps)
        k = L.rms_norm(k, p["kn"], cfg.norm_eps)
    return q, k, v


def _attn_out(cfg, p, out, x, cdt):
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return x + out @ p["wo"].to(cdt)


def _chunked_attention(q, k, v, window, prefix_len, chunk, cdt,
                       q_offset_base=0):
    """Row-chunked softmax attention: bounds logits memory to
    B*H*chunk*Sk."""
    Sq = q.shape[1]
    outs = []
    for i in range(Sq // chunk):
        mask = L.causal_mask(chunk, k.shape[1], window, prefix_len,
                             q_offset=q_offset_base + i * chunk,
                             device=q.device)
        outs.append(L.attention_scores(q[:, i * chunk:(i + 1) * chunk], k,
                                       v, mask[None], dtype=cdt))
    return torch.cat(outs, dim=1)


def attn_block(cfg, p, x, window: int, prefix_len, rc, positions=None,
               uniform_window=True):
    """Full-sequence self attention (train / prefill). Returns (x, (k, v)).

    The flash kernel is taken only without a prefix and when every layer
    has the same window (`uniform_window`), as in the reference."""
    cdt = _dtype(rc.compute_dtype)
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, cdt)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if cfg.rope_theta:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    if rc.attn_impl == "flash" and not prefix_len and uniform_window:
        if torch.is_grad_enabled() and q.requires_grad:
            raise NotImplementedError(
                "the flash-attention kernel is forward only, as the "
                "reference's is: train with attn_impl 'ref', 'chunked' or "
                "'auto'")
        # the hand-written kernel (kernels/flash_attention.py) reads the
        # (B,S,H,D) activations through their (B,H,S,D) views and writes
        # its output in q's order, (B,S,H,D): no copy on either side
        out = kops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=window)
        out = out.transpose(1, 2).to(cdt)
    elif rc.attn_impl == "chunked" or (rc.attn_impl == "auto" and S > 2048):
        chunk = next((c for c in (rc.attn_chunk, 512, 256, 128, 64)
                      if c <= S and S % c == 0), S)
        out = _chunked_attention(q, k, v, window, prefix_len, chunk, cdt)
    else:
        mask = L.causal_mask(S, S, window, prefix_len, device=x.device)
        out = L.attention_scores(q, k, v, mask[None], dtype=cdt)
    return _attn_out(cfg, p, out, x, cdt), (k, v)


def decode_attn_block(cfg, p, x, window, cache_k, cache_v, pos: int, rc):
    """One-token decode. cache_[kv]: (B, Smax, Hkv, Dh), written in place
    at `pos` (the reference returns updated copies).  Returns
    (x, (cache_k, cache_v))."""
    cdt = _dtype(rc.compute_dtype)
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x, cdt)  # S == 1
    posv = torch.full((B, 1), pos, device=x.device)
    if cfg.rope_theta:
        q = L.rope(q, posv, cfg.rope_theta)
        k = L.rope(k, posv, cfg.rope_theta)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    mask = L.decode_mask(cache_k.shape[1], pos, window, device=x.device)
    out = L.attention_scores(q, cache_k, cache_v, mask[None], dtype=cdt)
    return _attn_out(cfg, p, out, x, cdt), (cache_k, cache_v)


def mlp_block(cfg, p, x, rc):
    if cfg.is_moe:
        raise NotImplementedError(_NOT_PORTED["moe"])
    cdt = _dtype(rc.compute_dtype)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    g = h @ p["wg"].to(cdt)
    u = h @ p["wu"].to(cdt)
    hidden = L.act_fn(cfg.act)(g) * u
    y = hidden @ p["wd"].to(cdt)
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


# ----------------------------------------------------------------- stacks

def _embed(cfg, params, tokens, rc):
    """Gathers the rows, then casts them (the reference casts the table
    first: the same values, without a second copy of the table)."""
    cdt = _dtype(rc.compute_dtype)
    x = params["embed"][tokens].to(cdt)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt)
    return x


def forward(cfg: ModelConfig, params, batch, rc, return_cache=False):
    """Train/prefill forward. batch: tokens (B,S).

    Returns (logits_source_x, prefix_len, cache, enc_kv, aux)."""
    _dense_only(cfg)
    x = _embed(cfg, params, batch["tokens"], rc)
    prefix_len = 0
    w_arr = windows(cfg)
    uniform = bool((w_arr == w_arr[0]).all())   # enables the flash kernel
    ks, vs, aux = [], [], []

    def body(x, pl, window):
        x, (k, v) = attn_block(cfg, pl["attn"], x, window, prefix_len, rc,
                               uniform_window=uniform)
        x, a = mlp_block(cfg, pl["mlp"], x, rc)
        return x, k, v, a

    remat = rc.remat == "full" and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        pl = _layer(params["layers"], i)
        if remat:           # keep only the layer's input for the backward
            x, k, v, a = checkpoint(body, x, pl, int(w_arr[i]),
                                    use_reentrant=False)
        else:
            x, k, v, a = body(x, pl, int(w_arr[i]))
        aux.append(a)
        if return_cache:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} \
        if return_cache else None
    return x, prefix_len, cache, None, torch.stack(aux).sum()


def unembed(cfg, params, x, rc):
    cdt = _dtype(rc.compute_dtype)
    head = (params["embed"].to(cdt).T if cfg.tie_embeddings
            else params["lm_head"].to(cdt))
    return x @ head


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, dtype,
               windowed: bool = False):
    """KV-cache spec: {"k": (shape, dtype), "v": (shape, dtype)}, shapes
    (L, B, seq_len, Hkv, Dh)."""
    if windowed and cfg.sliding_window and cfg.global_every \
            and cfg.n_layers % cfg.global_every == 0:
        raise NotImplementedError(_NOT_PORTED["windowed"])
    if cfg.enc_layers:
        raise NotImplementedError(_NOT_PORTED["enc_dec"])
    n, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    return {"k": ((n, batch_size, seq_len, Hkv, Dh), dtype),
            "v": ((n, batch_size, seq_len, Hkv, Dh), dtype)}


def decode(cfg: ModelConfig, params, cache, token, pos: int, rc):
    """One-token decode step. token (B,1) int; pos an int.

    cache: {"k": (L,B,Smax,Hkv,Dh), "v": ...}, updated in place and
    returned.  Returns (logits (B,1,V), cache)."""
    if "k_loc" in cache:
        raise NotImplementedError(_NOT_PORTED["windowed"])
    _dense_only(cfg)
    x = _embed(cfg, params, token, rc)
    win = windows(cfg)
    for i in range(cfg.n_layers):
        pl = _layer(params["layers"], i)
        x, _ = decode_attn_block(cfg, pl["attn"], x, int(win[i]),
                                 cache["k"][i], cache["v"][i], pos, rc)
        x, _ = mlp_block(cfg, pl["mlp"], x, rc)
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return unembed(cfg, params, x, rc), cache
