"""Zamba2-7B — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]. Per-invocation LoRA on the shared block omitted."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="zamba2", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
    rope_theta=1e4, ssm_state=64, d_inner=7168, ssm_head_dim=64,
    attn_every=6, act="gelu")

SMOKE = CONFIG.scaled(n_layers=13, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=128, vocab=256, ssm_state=16,
                      d_inner=128, ssm_head_dim=16)
