"""AdamW with global-norm clipping, written by hand: the arithmetic of
`repro.optim.adamw`, which `torch.optim.AdamW` and `clip_grad_norm_` do
not reproduce.

  * the warmup factor min(1, (step + 1) / warmup) reads the step before
    its increment;
  * the clip scale is min(1, max / (norm + 1e-12)), and the reported
    norm is the one before clipping;
  * weight decay applies to every leaf, norms and embeddings included;
  * the update is p - lr * (mh / (sqrt(vh) + eps) + wd * p).

The state is {"step": int32 0-d tensor, "m": tree, "v": tree}, f32
moments keyed like the parameters, so a checkpoint stores the same bytes
as the reference's.  `apply_updates` writes parameters and moments in
place under torch.no_grad(); trees are nested dicts walked in sorted key
order, as JAX flattens them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import tree_get, tree_items, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # distributed-optimization tricks
    compress_grads: bool = False     # int8 error-feedback compression (DCN)


def init_state(params):
    dev = next(iter(tree_items(params)))[1].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


def _schedule(cfg: AdamWConfig, step):
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for _, g in tree_items(tree)))


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def compress_int8(g):
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step. grads in fp32 (or bf16), already averaged.

    Writes the parameters and the moments in place (the gradients are
    only read) and returns (params, new state, grad norm before
    clipping).  One leaf's temporaries live at a time."""
    step = state["step"] + 1
    lr = _schedule(cfg, state["step"])
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for path, p in tree_items(params):
        g = tree_get(grads, path).float() * scale           # clipped, f32
        m, v = tree_get(state["m"], path), tree_get(state["v"], path)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g.square_(), alpha=1 - b2)
        den = (v / bc2).sqrt_().add_(cfg.eps)
        delta = (m / bc1).div_(den).add_(p.float(), alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(p.float().sub_(delta.mul_(lr)))
    return params, {"step": step, "m": state["m"], "v": state["v"]}, gnorm
