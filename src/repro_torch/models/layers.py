"""Shared layers + parameter-definition infrastructure.

Every model builds a nested dict of ParamDef (shape, logical spec, init);
`tree_init` turns it into real tensors from an explicit torch.Generator
on the generator's device.  The logical specs are kept for the sharding
tools, which are not ported yet.

The layers compute what `repro.models.layers` computes: rms_norm scales
by (1 + w), RoPE rotates split halves, gelu is the tanh approximation,
masked logits are -1e30 and probabilities are cast to the compute dtype
before the PV product.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple  # logical axis per dim: "model" | "batch" | None
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0


def tree_items(tree, path=()):
    """(key path, leaf) pairs of a nested dict, keys in sorted order (the
    order in which JAX flattens a dict)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_items(tree[key], path + (key,))
    else:
        yield path, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def tree_get(tree, path):
    """The leaf at key path `path`."""
    for key in path:
        tree = tree[key]
    return tree


def tree_set(tree: dict, path, value):
    """Put `value` at key path `path`, making the dicts on the way."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def tree_init(defs, generator: torch.Generator, dtype=torch.float32):
    """Real tensors for `defs` on the generator's device: zeros / ones, or
    normal with std scale / sqrt(fan_in), drawn in float32 in the sorted
    leaf order and cast to `dtype`."""
    device = generator.device
    out = {}
    for path, d in tree_items(defs):
        if d.init == "zeros":
            a = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            a = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = d.scale / math.sqrt(max(1, fan_in))
            a = torch.randn(d.shape, generator=generator, device=device,
                            dtype=torch.float32).mul_(std).to(dtype)
        tree_set(out, path, a)
    return out


# ---------------------------------------------------------------- layers

def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope(x, positions, theta: float):
    """x: (..., S, H, D) rotary over D; positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.arange(0, half, dtype=torch.float32, device=x.device)
    inv = theta ** (-freqs / half)  # float32; no host-to-device copy
    ang = positions[..., None].float() * inv  # (..., S, half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    sin = sin[..., None, :]  # broadcast over heads
    cos = cos[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def attention_scores(q, k, v, mask, dtype=torch.bfloat16):
    """Reference (non-flash) attention. q:(B,Sq,H,D) k/v:(B,Sk,Hkv,D).

    GQA handled by reshaping q into (B,Sq,Hkv,G,D).  QK^T is taken in
    float32 (bf16 products are exact there)."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits / math.sqrt(D)
    keep = mask[:, None, None, :, :] if mask.dim() == 3 else mask
    logits = logits.masked_fill(~keep, -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    common = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(common), v.to(common))
    return out.reshape(B, Sq, H, D)


def causal_mask(Sq, Sk, window=0, prefix_len=0, q_offset=0, device=None):
    """(Sq, Sk) boolean mask. window>0 = sliding window; prefix bidirectional."""
    qp = torch.arange(Sq, device=device)[:, None] + q_offset
    kp = torch.arange(Sk, device=device)[None, :]
    m = kp <= qp
    if window > 0:
        m = m & ((qp - kp) < window)
    if prefix_len:
        both_prefix = (qp < prefix_len) & (kp < prefix_len)
        m = m | both_prefix
    return m


def decode_mask(Smax, pos: int, window=0, device=None):
    """(1, Smax) mask for one-token decode at position `pos` (inclusive)."""
    kp = torch.arange(Smax, device=device)[None, :]
    m = kp <= pos
    if window > 0:
        m = m & ((pos - kp) < window)
    return m
