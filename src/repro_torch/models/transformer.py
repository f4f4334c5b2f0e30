"""Unified decoder/encoder-decoder transformer: `repro.models.transformer`
in PyTorch.

Covers yi-9b, gemma3-12b (5:1 local:global), qwen3-4b (qk_norm), qwen2-7b
(qkv bias), paligemma-3b (patch-prefix VLM), phi3.5-moe and dbrx (MoE,
`models/moe.py`) and whisper-tiny (encoder-decoder over stub frame
embeddings).  Parameters are a nested dict of tensors keyed like
`param_defs`, each layer's weights stacked on a leading axis, so the two
packages exchange them (`models/convert.py`).  The reference's layer scan
is a Python loop over that axis; with `rc.remat == "full"` each layer
is recomputed in the backward pass (`torch.utils.checkpoint`), as the
reference's `_maybe_remat` does.  Each layer gets its window as an int;
the flash kernel is taken only without a prefix and when every layer has
the same window, as in the reference, where a per-layer window is traced
(so paligemma's prefix, whisper's encoder and gemma3's local:global mix
take the plain attention).  The kernel is forward only, as the
reference's is: attention that needs a gradient raises on the flash
path.  Decode caches are written in place (the reference returns updated
copies); `init_cache(windowed=True)` gives gemma3-style mixes a ring
buffer of `sliding_window` slots for each local layer (`decode_windowed`).

Under a mesh (`parallel/shardings.py`) parameters and activations are
DTensors: `constrain` pins the activations where the reference pins
them, each layer gathers its FSDP-sharded weights inside its remat region
(`layers.layer`), and the flash kernel runs on each device's own batch
rows and heads through `local_map`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch import trace
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import shardings as sh
from repro_torch.parallel.shardings import constrain


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
        defs = {
            "ln": D(d, lg=(None,), init="zeros"),
            "router": D(d, E, lg=(None, None)),
            "wg": D(E, d, f, lg=("model", None, None)),
            "wu": D(E, d, f, lg=("model", None, None)),
            "wd": D(E, f, d, lg=("model", None, None)),
        }
        if cfg.d_ff_shared:
            fs = cfg.d_ff_shared
            defs |= {"shared_wg": D(d, fs, lg=(None, "model")),
                     "shared_wu": D(d, fs, lg=(None, "model")),
                     "shared_wd": D(fs, d, lg=("model", None))}
        return defs
    f = cfg.d_ff
    return {
        "ln": D(d, lg=(None,), init="zeros"),
        "wg": D(d, f, lg=(None, "model")),
        "wu": D(d, f, lg=(None, "model")),
        "wd": D(f, d, lg=("model", None)),
    }


def param_defs(cfg: ModelConfig):
    """The reference's parameter tree, as ParamDefs."""
    d, V = cfg.d_model, cfg.vocab
    n = cfg.n_layers
    defs = {
        "embed": L.ParamDef((V, d), ("model", None), scale=float(np.sqrt(d))),
        "final_ln": L.ParamDef((d,), (None,), init="zeros"),
        "layers": {"attn": _attn_defs(cfg, n), "mlp": _mlp_defs(cfg, n)},
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = L.ParamDef((d, V), (None, "model"))
    if cfg.enc_layers:  # whisper-style encoder + cross attention
        ne = cfg.enc_layers
        defs["enc_layers"] = {"attn": _attn_defs(cfg, ne),
                              "mlp": _mlp_defs(cfg, ne)}
        defs["enc_final_ln"] = L.ParamDef((d,), (None,), init="zeros")
        defs["layers"]["xattn"] = _attn_defs(cfg, n, cross=True)
        defs["dec_pos"] = L.ParamDef((32768, d), (None, None), init="zeros")
    if cfg.n_patches:  # paligemma: projection for stub patch embeddings
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


# ----------------------------------------------------------------- blocks

def _qkv(cfg, p, x, cdt):
    B, S, d = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    q = L.matmul(h, p["wq"].to(cdt))
    k = L.matmul(h, p["wk"].to(cdt))
    v = L.matmul(h, p["wv"].to(cdt))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = L.split_heads(q, H, Dh)
    k = L.split_heads(k, Hkv, Dh)
    v = L.split_heads(v, Hkv, Dh)
    if "qn" in p:
        q = L.rms_norm(q, p["qn"], cfg.norm_eps)
        k = L.rms_norm(k, p["kn"], cfg.norm_eps)
    q = constrain(q, ("batch", None, "model", None))
    return q, k, v


def _residual(cfg, x, y):
    """x + y, y times `cfg.residual_mult` first where that is not 1."""
    if cfg.residual_mult != 1.0:
        y = y * cfg.residual_mult
    return constrain(x + y, ("batch", None, None))


def _scale(cfg):
    """The softmax scale: `cfg.attn_scale`, or None (1/sqrt(D)) at 0."""
    return cfg.attn_scale or None


def _attn_out(cfg, p, out, x, cdt):
    out = L.merge_heads(out)
    return _residual(cfg, x, L.matmul(out, p["wo"].to(cdt)))


def _chunked_attention(q, k, v, window, prefix_len, chunk, cdt,
                       q_offset_base=0, scale=None):
    """Row-chunked softmax attention: bounds logits memory to
    B*H*chunk*Sk."""
    Sq = q.shape[1]
    outs = []
    for i in range(Sq // chunk):
        mask = L.causal_mask(chunk, k.shape[1], window, prefix_len,
                             q_offset=q_offset_base + i * chunk,
                             device=q.device)
        outs.append(L.attention_scores(q[:, i * chunk:(i + 1) * chunk], k,
                                       v, mask[None], dtype=cdt,
                                       scale=scale))
    return torch.cat(outs, dim=1)


def attn_block(cfg, p, x, window: int, prefix_len, rc, positions=None,
               uniform_window=True):
    """Full-sequence self attention (train / prefill). Returns (x, (k, v)).

    The flash kernel is taken only without a prefix and when every layer
    has the same window (`uniform_window`), as in the reference."""
    with trace.span("rt:attn"):
        cdt = _dtype(rc.compute_dtype)
        B, S, _ = x.shape
        q, k, v = _qkv(cfg, p, x, cdt)
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        if cfg.rope_theta:
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
        k = constrain(k, ("batch", None, "model", None))
        v = constrain(v, ("batch", None, "model", None))
        with trace.span("rt:attn.kernel"):
            out = _attention(q, k, v, window, prefix_len, rc, cdt,
                             uniform_window, _scale(cfg))
        return _attn_out(cfg, p, out, x, cdt), (k, v)


def _attention(q, k, v, window: int, prefix_len, rc, cdt, uniform_window,
               scale=None):
    """Softmax attention of (B,S,H,D) q over k, v: the flash kernel, the
    row-chunked form or the whole scores, by `rc.attn_impl`; `scale`
    None is 1/sqrt(D)."""
    S = q.shape[1]
    if rc.attn_impl == "flash" and not prefix_len and uniform_window:
        if torch.is_grad_enabled() and q.requires_grad:
            raise NotImplementedError(
                "the flash-attention kernel is forward only, as the "
                "reference's is: train with attn_impl 'ref', 'chunked' or "
                "'auto'")
        return _flash(q, k, v, window, scale).to(cdt)
    if rc.attn_impl == "chunked" or (rc.attn_impl == "auto" and S > 2048):
        chunk = next((c for c in (rc.attn_chunk, 512, 256, 128, 64)
                      if c <= S and S % c == 0), S)
        return _chunked_attention(q, k, v, window, prefix_len, chunk, cdt,
                                  scale=scale)
    mask = L.causal_mask(S, S, window, prefix_len, device=q.device)
    return L.attention_scores(q, k, v, mask[None], dtype=cdt, scale=scale)


def _flash(q, k, v, window: int, scale=None):
    """The hand-written kernel (kernels/flash_attention.py) on (B,S,H,D)
    activations: it reads them through their (B,H,S,D) views and writes
    its output in q's order, (B,S,H,D), with no copy on either side.

    On DTensors it runs through `local_map`: each device takes its own
    batch rows over the dp axes and its own heads over "model" (heads stay
    whole when the model axis does not divide both H and Hkv, so that
    every local query head finds its KV head), and launches the kernel on
    those."""
    def run(q, k, v):
        return kops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=window, scale=scale).transpose(1, 2)

    if not isinstance(q, DTensor):
        return run(q, k, v)
    mesh = q.device_mesh
    spec = sh.resolve_spec(mesh, ("batch", None, "model", None), q.shape)
    if sh.resolve_spec(mesh, ("batch", None, "model", None),
                       k.shape)[2] is None:
        spec = (spec[0], None, None, None)
    pl = sh.placements(mesh, spec)
    # one output: its placements as a list (a tuple reads as several)
    return local_map(run, out_placements=list(pl), in_placements=(pl, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def cross_attn_block(cfg, p, x, enc_kv, rc):
    """Attention of the decoder over the encoder's K/V (B, F, Hkv, Dh),
    every frame visible."""
    cdt = _dtype(rc.compute_dtype)
    B, S, d = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    q = L.split_heads(L.matmul(h, p["wq"].to(cdt)), H, Dh)
    k, v = enc_kv
    mask = torch.ones((1, S, k.shape[1]), dtype=torch.bool, device=x.device)
    out = L.attention_scores(q, k, v, mask, dtype=cdt, scale=_scale(cfg))
    return _attn_out(cfg, p, out, x, cdt)


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
    out = L.attention_scores(q, cache_k, cache_v, mask[None], dtype=cdt,
                             scale=_scale(cfg))
    return _attn_out(cfg, p, out, x, cdt), (cache_k, cache_v)


def mlp_block(cfg, p, x, rc):
    """Returns (x, aux): the MoE load-balance loss, 0 for a dense MLP."""
    cdt = _dtype(rc.compute_dtype)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    if cfg.is_moe:
        B, S, d = x.shape
        # the dispatch may split the tokens where the batch could not be
        # split (T divides the dp axes, B does not): its output, and its
        # input's gradient, go back to the input's layout, which folds
        # into (B, S)
        hf = L.grad_as_forward(h.reshape(B * S, d))
        y, aux = moe_lib.moe_ffn(cfg, p, hf, rc)
        if isinstance(y, DTensor):
            y = y.redistribute(hf.device_mesh, hf.placements)
        return _residual(cfg, x, y.reshape(B, S, d)), aux
    with trace.span("rt:mlp"):
        g = L.matmul(h, p["wg"].to(cdt))
        u = L.matmul(h, p["wu"].to(cdt))
        hidden = L.act_fn(cfg.act)(g) * u
        hidden = constrain(hidden, ("batch", None, "model"))
        y = L.matmul(hidden, p["wd"].to(cdt))
        return (_residual(cfg, x, y),
                torch.zeros((), dtype=torch.float32, device=x.device))


# ----------------------------------------------------------------- stacks

def _remat(rc) -> bool:
    """Recompute each layer in the backward pass (only when a backward
    can follow)."""
    return rc.remat == "full" and torch.is_grad_enabled()


def _run(fn, remat: bool, *args):
    """fn(*args), keeping only its inputs for the backward when `remat`."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encoder_forward(cfg, params, frames, rc):
    """Whisper-style encoder over stub frame embeddings (B, F, d):
    bidirectional (the whole input is the prefix), so never flash."""
    x = frames.to(_dtype(rc.compute_dtype))

    def body(x, stacked, i):
        pl = L.layer(stacked, i)
        x, _ = attn_block(cfg, pl["attn"], x, 0, x.shape[1], rc)
        x, _ = mlp_block(cfg, pl["mlp"], x, rc)
        return x

    remat = _remat(rc)
    for i in range(cfg.enc_layers):
        x = _run(body, remat, x, params["enc_layers"], i)
    return L.rms_norm(x, sh.unshard(params["enc_final_ln"]), cfg.norm_eps)


def _embed(cfg, params, tokens, rc):
    """Gathers the rows, then casts them (the reference casts the table
    first: the same values, without a second copy of the table)."""
    cdt = _dtype(rc.compute_dtype)
    x = sh.unshard(params["embed"])[tokens].to(cdt)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt)
    if cfg.embed_mult != 1.0:
        x = x * cfg.embed_mult
    return constrain(x, ("batch", None, None))


def _inputs_with_prefix(cfg, params, tokens, batch, rc):
    """Token embeddings behind paligemma's projected patch prefix, or
    with whisper's decoder positions added.  Returns (x, prefix_len)."""
    x = _embed(cfg, params, tokens, rc)
    prefix_len = 0
    if cfg.n_patches:
        cdt = x.dtype
        patches = L.matmul(batch["patches"].to(cdt),
                           sh.unshard(params["patch_proj"]).to(cdt))
        x = torch.cat([patches, x], dim=1)
        prefix_len = cfg.n_patches
    if cfg.enc_layers:
        S = x.shape[1]
        x = x + sh.unshard(params["dec_pos"])[:S].to(x.dtype)[None]
    return x, prefix_len


def forward(cfg: ModelConfig, params, batch, rc, return_cache=False):
    """Train/prefill forward. batch: tokens (B,S) [+ patches (B,P,d) /
    frames (B,F,d)].

    Returns (logits_source_x, prefix_len, cache, enc_out, aux): the cache
    holds each layer's K/V over all S + P positions and, with an encoder,
    each layer's cross K/V over the F frames; aux sums the layers' MoE
    load-balance losses."""
    x, prefix_len = _inputs_with_prefix(cfg, params, batch["tokens"], batch,
                                        rc)
    w_arr = windows(cfg)
    uniform = bool((w_arr == w_arr[0]).all())   # enables the flash kernel
    enc_out = (encoder_forward(cfg, params, batch["frames"], rc)
               if cfg.enc_layers else None)
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim

    def body(x, stacked, i, window):
        pl = L.layer(stacked, i)
        x, (k, v) = attn_block(cfg, pl["attn"], x, window, prefix_len, rc,
                               uniform_window=uniform)
        xk = xv = None
        if enc_out is not None:         # this layer's cross K/V
            cdt = x.dtype
            B, F, _ = enc_out.shape
            xk = L.split_heads(L.matmul(enc_out, pl["xattn"]["wk"].to(cdt)),
                               Hkv, Dh)
            xv = L.split_heads(L.matmul(enc_out, pl["xattn"]["wv"].to(cdt)),
                               Hkv, Dh)
            x = cross_attn_block(cfg, pl["xattn"], x, (xk, xv), rc)
        x, a = mlp_block(cfg, pl["mlp"], x, rc)
        return x, k, v, xk, xv, a

    remat = _remat(rc)
    kept, aux = [], []
    for i in range(cfg.n_layers):
        x, k, v, xk, xv, a = _run(body, remat, x, params["layers"], i,
                                  int(w_arr[i]))
        aux.append(a)
        if return_cache:
            kept.append((k, v, xk, xv))
    x = L.rms_norm(x, sh.unshard(params["final_ln"]), cfg.norm_eps)
    cache = None
    if return_cache:
        ks, vs, xks, xvs = zip(*kept)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if cfg.enc_layers:
            cache["xk"], cache["xv"] = torch.stack(xks), torch.stack(xvs)
    return x, prefix_len, cache, enc_out, torch.stack(aux).sum()


def unembed(cfg, params, x, rc):
    cdt = _dtype(rc.compute_dtype)
    head = (sh.unshard(params["embed"]).to(cdt).T if cfg.tie_embeddings
            else sh.unshard(params["lm_head"]).to(cdt))
    logits = L.matmul(x, head)
    if cfg.logits_scale != 1.0:
        logits = logits / cfg.logits_scale
    return constrain(logits, ("batch", None, "model"))


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, dtype,
               windowed: bool = False):
    """KV-cache spec: {name: (shape, dtype)}.  "k"/"v" (L, B, seq_len, Hkv,
    Dh), with an encoder "xk"/"xv" (L, B, enc_frames, Hkv, Dh).

    windowed=True (gemma3-style local:global mixes, when global_every
    divides n_layers): each group of `global_every` layers keeps its local
    layers' K/V in a ring of W = min(sliding_window, seq_len) slots
    ("k_loc"/"v_loc" (ng, global_every - 1, B, W, Hkv, Dh)) and its global
    layer's over the whole context ("k_glob"/"v_glob" (ng, B, seq_len,
    Hkv, Dh))."""
    n, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if windowed and cfg.sliding_window and cfg.global_every \
            and n % cfg.global_every == 0:
        ng = n // cfg.global_every
        nloc = cfg.global_every - 1
        W = min(cfg.sliding_window, seq_len)
        return {
            "k_loc": ((ng, nloc, batch_size, W, Hkv, Dh), dtype),
            "v_loc": ((ng, nloc, batch_size, W, Hkv, Dh), dtype),
            "k_glob": ((ng, batch_size, seq_len, Hkv, Dh), dtype),
            "v_glob": ((ng, batch_size, seq_len, Hkv, Dh), dtype),
        }
    c = {"k": ((n, batch_size, seq_len, Hkv, Dh), dtype),
         "v": ((n, batch_size, seq_len, Hkv, Dh), dtype)}
    if cfg.enc_layers:
        c["xk"] = ((n, batch_size, cfg.enc_frames, Hkv, Dh), dtype)
        c["xv"] = ((n, batch_size, cfg.enc_frames, Hkv, Dh), dtype)
    return c


def cache_logical():
    # seq dim falls back to the data axes ("batch2") when batch cannot
    # claim them (e.g. long_500k with global_batch=1)
    base = (None, "batch", "batch2", "model", "model2")
    return {"k": base, "v": base, "xk": base, "xv": base,
            "k_loc": (None, None, "batch", None, "model", "model2"),
            "v_loc": (None, None, "batch", None, "model", "model2"),
            "k_glob": base, "v_glob": base}


def decode_attn_block_ring(cfg, p, x, window, cache_k, cache_v, pos: int,
                           rc):
    """Sliding-window decode against a RING buffer of W = cache_k.shape[1]
    slots, written in place at slot pos mod W.  Slot s holds absolute
    position pos - ((pos - s) mod W); the mask only rejects slots whose
    position is still negative (cold start)."""
    cdt = _dtype(rc.compute_dtype)
    B = x.shape[0]
    W = cache_k.shape[1]
    q, k, v = _qkv(cfg, p, x, cdt)
    posv = torch.full((B, 1), pos, device=x.device)
    if cfg.rope_theta:
        q = L.rope(q, posv, cfg.rope_theta)
        k = L.rope(k, posv, cfg.rope_theta)
    slot = pos % W
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    slots = torch.arange(W, device=x.device)
    abs_pos = pos - torch.remainder(pos - slots, W)
    mask = (abs_pos >= 0)[None, :]
    out = L.attention_scores(q, cache_k, cache_v, mask[None], dtype=cdt,
                             scale=_scale(cfg))
    return _attn_out(cfg, p, out, x, cdt), (cache_k, cache_v)


def decode_windowed(cfg: ModelConfig, params, cache, token, pos: int, rc):
    """Decode for local:global mixes with ring-buffered local caches: the
    layers run as groups of `global_every`, its local layers on their
    rings, then its global layer on the full cache.  The cache is written
    in place and returned."""
    x = _embed(cfg, params, token, rc)
    per = cfg.global_every
    W = cfg.sliding_window
    for g in range(cfg.n_layers // per):
        for j in range(per - 1):
            pl = L.layer(params["layers"], g * per + j)
            x, _ = decode_attn_block_ring(cfg, pl["attn"], x, W,
                                          cache["k_loc"][g, j],
                                          cache["v_loc"][g, j], pos, rc)
            x, _ = mlp_block(cfg, pl["mlp"], x, rc)
        pl = L.layer(params["layers"], g * per + per - 1)
        x, _ = decode_attn_block(cfg, pl["attn"], x, 0, cache["k_glob"][g],
                                 cache["v_glob"][g], pos, rc)
        x, _ = mlp_block(cfg, pl["mlp"], x, rc)
    x = L.rms_norm(x, sh.unshard(params["final_ln"]), cfg.norm_eps)
    return unembed(cfg, params, x, rc), cache


def decode(cfg: ModelConfig, params, cache, token, pos: int, rc):
    """One-token decode step. token (B,1) int; pos an int.

    cache: {"k": (L,B,Smax,Hkv,Dh), "v": ..., ["xk", "xv"]} or the
    windowed layout {"k_loc", "v_loc", "k_glob", "v_glob"}, updated in
    place and returned.  Returns (logits (B,1,V), cache)."""
    if "k_loc" in cache:
        return decode_windowed(cfg, params, cache, token, pos, rc)
    x = _embed(cfg, params, token, rc)
    if cfg.enc_layers:
        x = x + sh.unshard(params["dec_pos"])[pos].to(x.dtype)[None, None]
    win = windows(cfg)
    for i in range(cfg.n_layers):
        pl = L.layer(params["layers"], i)
        x, _ = decode_attn_block(cfg, pl["attn"], x, int(win[i]),
                                 cache["k"][i], cache["v"][i], pos, rc)
        if cfg.enc_layers:
            x = cross_attn_block(cfg, pl["xattn"], x,
                                 (cache["xk"][i], cache["xv"][i]), rc)
        x, _ = mlp_block(cfg, pl["mlp"], x, rc)
    x = L.rms_norm(x, sh.unshard(params["final_ln"]), cfg.norm_eps)
    return unembed(cfg, params, x, rc), cache
