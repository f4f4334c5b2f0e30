"""Granite 4.0-H Small: 36 Mamba2 and 4 NoPE GQA attention layers, each
followed by 72 SwiGLU experts (top-10) and a shared expert; 32B total, 9B
active [hf:ibm-granite/granite-4.0-h-small, config.json].

Departures of the port: RMSNorm scales by 1 + w; each expert takes at
most capacity_factor 1.25 x T k / E assignments (the published model
drops none)."""
from repro_torch.models.config import ModelConfig

PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = ModelConfig(
    name="granite-4.0-h-small", family="granite_hybrid", n_layers=40,
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128, vocab=100352,
    rope_theta=0.0, n_experts=72, top_k=10, d_ff_expert=768,
    capacity_factor=1.25, ssm_state=128, d_inner=8192, ssm_head_dim=64,
    conv_width=4, act="silu", norm_eps=1e-5, tie_embeddings=True,
    layer_types=PERIOD * 4, embed_mult=12.0, residual_mult=0.22,
    attn_scale=0.0078125, logits_scale=16.0, d_ff_shared=1536,
    conv_bias=True)

# one period of the pattern (attention at layer 5)
SMOKE = CONFIG.scaled(n_layers=10, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, vocab=256, n_experts=8, top_k=3,
                      d_ff_expert=32, d_ff_shared=48, ssm_state=16,
                      d_inner=128, ssm_head_dim=16, layer_types=PERIOD,
                      attn_scale=0.125)
