"""Qwen3-4B — dense GQA with qk-norm [hf:Qwen/Qwen3-4B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="transformer", n_layers=36, d_model=2560,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=9728, vocab=151936,
    rope_theta=1e6, qk_norm=True, act="silu")

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=256)
