"""Qwen2-7B — dense GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="transformer", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, head_dim=128, d_ff=18944, vocab=152064,
    rope_theta=1e6, qkv_bias=True, act="silu")

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=256)
