"""Yi-9B — llama-arch dense GQA [arXiv:2403.04652; hf:01-ai/Yi-9B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="transformer", n_layers=48, d_model=4096,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=11008, vocab=64000,
    rope_theta=5e6, act="silu")

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=256)
