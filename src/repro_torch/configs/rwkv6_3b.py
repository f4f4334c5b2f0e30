"""RWKV-6 "Finch" 3B — attention-free, data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv6", n_layers=32, d_model=2560,
    d_ff=8960, vocab=65536, rwkv_head_dim=64)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, d_ff=128, vocab=256,
                      rwkv_head_dim=16)
