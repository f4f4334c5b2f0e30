"""Whisper-tiny — enc-dec audio transformer; conv frontend is a stub
(input_specs provides 1500 precomputed frame embeddings)
[arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="transformer", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, head_dim=64, d_ff=1536, vocab=51865,
    rope_theta=0.0, enc_layers=4, enc_frames=1500, act="gelu")

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=128, vocab=256, enc_layers=2,
                      enc_frames=16)
