"""PaliGemma-3B — gemma decoder + SigLIP patch-prefix (stub frontend)
[arXiv:2407.07726]. Patch embeddings arrive precomputed at d_model."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="transformer", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384, vocab=257216,
    rope_theta=1e4, n_patches=256, act="gelu", embed_scale=True)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                      head_dim=16, d_ff=128, vocab=256, n_patches=8)
