"""Phi-3.5-MoE — 16 experts top-2, 42B total / 6.6B active
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe", family="transformer", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=6400, vocab=32064,
    rope_theta=1e4, n_experts=16, top_k=2, d_ff_expert=6400, act="silu")

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=256, n_experts=4,
                      top_k=2, d_ff_expert=128)
