"""DBRX — 132B MoE, 16 experts top-4, fine-grained
[hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="transformer", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=10752, vocab=100352,
    rope_theta=5e5, n_experts=16, top_k=4, d_ff_expert=10752, act="silu")

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=256, n_experts=4,
                      top_k=2, d_ff_expert=128)
