"""Gemma3-12B — 5:1 local:global attention, qk-norm, 256k vocab
[hf:google/gemma-3-12b-pt]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="transformer", n_layers=48, d_model=3840,
    n_heads=16, n_kv_heads=8, head_dim=256, d_ff=15360, vocab=262144,
    rope_theta=1e6, sliding_window=1024, global_every=6, qk_norm=True,
    act="gelu", embed_scale=True)

SMOKE = CONFIG.scaled(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=256, sliding_window=8)
