"""Granite 4.0-H (`granitemoehybrid`): a stack of Mamba2 and attention
layers, typed by `cfg.layer_types`, each mixer followed by an MoE FFN with
a shared expert.

    x <- x + r * mixer(rms(x))             mixer: Mamba2 or attention
    x <- x + r * (routed experts(rms(x)) + shared expert(rms(x)))

with r = `cfg.residual_mult`, the embeddings times `cfg.embed_mult`, the
attention's softmax scale `cfg.attn_scale` and no position embedding
(`rope_theta` 0), and the logits divided by `cfg.logits_scale`
(`transformer.unembed`).  The blocks are the other families' own:
`zamba2._mamba_block` (with its conv bias), `transformer.attn_block` /
`decode_attn_block` and `transformer.mlp_block` over `moe.moe_ffn`.

Mamba2 layers and attention layers are stacked apart ("mamba_layers",
"attn_layers", each a mixer and its FFN), in layer order within each
stack.  The cache keeps every Mamba2 layer's conv window and SSM state
("conv" (nm, B, W-1, conv_dim), "state" (nm, B, H, N, P) float32) beside
every attention layer's K/V ("k"/"v" (na, B, S, Hkv, Dh)).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models import zamba2
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import shardings as sh

MAMBA, ATTENTION = "mamba", "attention"


def counts(cfg: ModelConfig) -> tuple[int, int]:
    """(Mamba2 layers, attention layers)."""
    if len(cfg.layer_types) != cfg.n_layers or \
            set(cfg.layer_types) - {MAMBA, ATTENTION}:
        raise ValueError(f"layer_types must give each of {cfg.n_layers} "
                         f"layers {MAMBA!r} or {ATTENTION!r}")
    nm = cfg.layer_types.count(MAMBA)
    return nm, cfg.n_layers - nm


def param_defs(cfg: ModelConfig):
    d, V = cfg.d_model, cfg.vocab
    nm, na = counts(cfg)
    defs = {
        "embed": L.ParamDef((V, d), ("model", None), scale=d ** 0.5),
        "final_ln": L.ParamDef((d,), (None,), init="zeros"),
        "mamba_layers": {"mixer": zamba2._mamba_defs(cfg, (nm,)),
                         "mlp": tfm._mlp_defs(cfg, nm)},
        "attn_layers": {"attn": tfm._attn_defs(cfg, na),
                        "mlp": tfm._mlp_defs(cfg, na)},
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = L.ParamDef((d, V), (None, "model"))
    return defs


def _order(cfg):
    """(kind, index in its stack) of each layer."""
    seen = {MAMBA: 0, ATTENTION: 0}
    for kind in cfg.layer_types:
        yield kind, seen[kind]
        seen[kind] += 1


def forward(cfg: ModelConfig, params, batch, rc, return_cache=False):
    """Returns (x, 0, cache, None, aux): x after the final norm, and with
    `return_cache` the conv windows, SSM states and K/V of every layer."""
    counts(cfg)
    x = tfm._embed(cfg, params, batch["tokens"], rc)

    def mamba(x, stacked, j):
        pl = L.layer(stacked, j)
        x, cs, st = zamba2._mamba_block(cfg, pl["mixer"], x, rc)
        x, a = tfm.mlp_block(cfg, pl["mlp"], x, rc)
        # the conv window is a view of the block's whole conv input: a
        # copy lets that go with the block (36 of them: 5 GB at 8192)
        return x, cs.clone(), st, a

    def attention(x, stacked, j):
        pl = L.layer(stacked, j)
        x, (k, v) = tfm.attn_block(cfg, pl["attn"], x, 0, 0, rc)
        x, a = tfm.mlp_block(cfg, pl["mlp"], x, rc)
        return x, k, v, a

    remat = tfm._remat(rc)
    kept = {MAMBA: [], ATTENTION: []}
    aux = []
    for kind, j in _order(cfg):
        if kind == MAMBA:
            x, *out, a = tfm._run(mamba, remat, x, params["mamba_layers"], j)
        else:
            x, *out, a = tfm._run(attention, remat, x, params["attn_layers"],
                                  j)
        aux.append(a)
        if return_cache:
            kept[kind].append(out)
    x = L.rms_norm(x, sh.unshard(params["final_ln"]), cfg.norm_eps)
    cache = None
    if return_cache:
        cache = {}
        for kind, names in ((MAMBA, ("conv", "state")),
                            (ATTENTION, ("k", "v"))):
            if kept[kind]:
                for name, ts in zip(names, zip(*kept[kind])):
                    cache[name] = torch.stack(ts)
    return x, 0, cache, None, torch.stack(aux).sum()


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, dtype):
    """{name: (shape, dtype)}: SSM states stay f32 whatever `dtype`."""
    nm, na = counts(cfg)
    d_in, H, P, N, conv_dim = zamba2._dims(cfg)
    W = cfg.conv_width
    kv = (na, batch_size, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"conv": ((nm, batch_size, W - 1, conv_dim), dtype),
            "state": ((nm, batch_size, H, N, P), torch.float32),
            "k": (kv, dtype), "v": (kv, dtype)}


def cache_logical():
    return {"conv": (None, "batch", None, "model"),
            "state": (None, "batch", None, None, "model"),
            "k": (None, "batch", "batch2", "model", "model2"),
            "v": (None, "batch", "batch2", "model", "model2")}


def decode(cfg: ModelConfig, params, cache, token, pos: int, rc):
    """One-token step: each Mamba2 layer's conv window and SSM state and
    each attention layer's K/V advance in place.  Returns (logits
    (B,1,V), cache)."""
    x = tfm._embed(cfg, params, token, rc)
    for kind, j in _order(cfg):
        if kind == MAMBA:
            pl = L.layer(params["mamba_layers"], j)
            x, cs, st = zamba2._mamba_block(
                cfg, pl["mixer"], x, rc, conv_prev=cache["conv"][j],
                state=cache["state"][j])
            cache["conv"][j].copy_(cs)
            cache["state"][j].copy_(st)
        else:
            pl = L.layer(params["attn_layers"], j)
            x, _ = tfm.decode_attn_block(cfg, pl["attn"], x, 0,
                                         cache["k"][j], cache["v"][j], pos,
                                         rc)
        x, _ = tfm.mlp_block(cfg, pl["mlp"], x, rc)
    x = L.rms_norm(x, sh.unshard(params["final_ln"]), cfg.norm_eps)
    return tfm.unembed(cfg, params, x, rc), cache
