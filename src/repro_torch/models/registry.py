"""Family dispatch + analytic parameter counts."""
from __future__ import annotations

import math

from repro_torch.models import layers as L
from repro_torch.models import granite_hybrid, rwkv6, transformer, zamba2
from repro_torch.models.config import ModelConfig

FAMILY = {"transformer": transformer, "rwkv6": rwkv6, "zamba2": zamba2,
          "granite_hybrid": granite_hybrid}


def module(cfg: ModelConfig):
    return FAMILY[cfg.family]


def param_defs(cfg: ModelConfig):
    return module(cfg).param_defs(cfg)


def init_cache(cfg, batch_size, seq_len, dtype, windowed=False):
    """{name: (shape, dtype)}; `windowed` applies to the transformer
    family only."""
    if cfg.family == "transformer":
        return module(cfg).init_cache(cfg, batch_size, seq_len, dtype,
                                      windowed)
    return module(cfg).init_cache(cfg, batch_size, seq_len, dtype)


def cache_logical(cfg):
    """Each cache entry's logical spec (`shardings.resolve_spec`)."""
    return module(cfg).cache_logical()


def forward(cfg, params, batch, rc, return_cache=False):
    return module(cfg).forward(cfg, params, batch, rc, return_cache)


def decode(cfg, params, cache, token, pos, rc):
    return module(cfg).decode(cfg, params, cache, token, pos, rc)


unembed = transformer.unembed  # shared: all families use embed/lm_head


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Matmul-relevant parameter count (excludes embedding gather tables &
    positional tables; includes lm_head). MoE expert weights are scaled by
    top_k/n_experts when active_only."""
    total = 0.0
    for keys, d in L.tree_items(param_defs(cfg)):
        if "embed" in keys or "dec_pos" in keys:
            continue
        n = math.prod(d.shape)
        if cfg.is_moe and len(d.shape) == 4 and d.shape[1] == cfg.n_experts:
            if active_only:
                n = n * cfg.top_k / cfg.n_experts
        total += n
    return int(total)
