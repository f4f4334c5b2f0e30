"""The 40 assigned (architecture x shape) cells and skip rules."""
from __future__ import annotations

from repro_torch.configs import ARCHS
from repro_torch.models.config import SHAPES

# Per-cell RunConfig overrides (baseline must FIT the 16 GB/chip HBM):
# MoE dispatch buffers scale with microbatch tokens -> more accumulation
# steps for the MoE giants.
OVERRIDES = {
    ("phi3.5-moe", "train_4k"): {"num_microbatches": 16,
                                 "shard_moe_tokens": True},
    ("dbrx-132b", "train_4k"): {"num_microbatches": 16,
                                "shard_moe_tokens": True},
    ("phi3.5-moe", "prefill_32k"): {"shard_moe_tokens": True},
    ("dbrx-132b", "prefill_32k"): {"shard_moe_tokens": True},
    ("phi3.5-moe", "decode_32k"): {"shard_moe_tokens": True},
    ("dbrx-132b", "decode_32k"): {"shard_moe_tokens": True},
    # ring-buffered local caches for the 5:1 local:global mix (§Perf)
    ("gemma3-12b", "decode_32k"): {"windowed_cache": True},
    ("gemma3-12b", "long_500k"): {"windowed_cache": True},
}
# (chunked_ce overrides were tried for the big-vocab train cells and
# REFUTED: logits are already vocab+batch sharded, the peak is the remat
# residual stack — see EXPERIMENTS.md §Perf)

# long_500k needs sub-quadratic attention: runs for SSM/hybrid and for
# gemma3 (5:1 local:global — decode cost is linear per token); skipped for
# pure full-attention archs (see DESIGN.md §3).
LONG_OK = {"rwkv6-3b", "zamba2-7b", "gemma3-12b"}

SKIP = {}
for _a in ARCHS:
    if _a not in LONG_OK:
        SKIP[(_a, "long_500k")] = (
            "full quadratic attention at 524k context (no sub-quadratic "
            "path in this family); see DESIGN.md §3")


def cells(include_skipped: bool = False):
    for arch in ARCHS:
        for shape in SHAPES:
            if (arch, shape) in SKIP and not include_skipped:
                continue
            yield arch, shape


def cell_skips():
    return dict(SKIP)
