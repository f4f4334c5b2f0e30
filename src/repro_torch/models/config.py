"""Architecture + run configuration dataclasses."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # transformer | rwkv6 | zamba2
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 0
    # attention details
    rope_theta: float = 1e4
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0          # window size for local layers (0 = full)
    global_every: int = 0            # gemma3: every Nth layer is global attn
    logit_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # encoder-decoder (whisper) / VLM (paligemma) stub frontends
    enc_layers: int = 0
    enc_frames: int = 0              # precomputed frame embeddings (stub)
    n_patches: int = 0               # precomputed patch embeddings (stub)
    # SSM / hybrid
    ssm_state: int = 0
    d_inner: int = 0
    ssm_head_dim: int = 64
    conv_width: int = 4
    attn_every: int = 0              # zamba2: shared attn block period
    rwkv_head_dim: int = 64
    # misc
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma multiplies embeddings by sqrt(d)
    # granite_hybrid (the port's own): at these defaults nothing is applied
    layer_types: tuple = ()          # each layer's mixer: mamba | attention
    embed_mult: float = 1.0          # embeddings times this
    residual_mult: float = 1.0       # each sublayer's output times this
    attn_scale: float = 0.0          # softmax scale; 0: 1/sqrt(head_dim)
    logits_scale: float = 1.0        # logits divided by this
    d_ff_shared: int = 0             # a shared SwiGLU expert's width
    conv_bias: bool = False          # Mamba2's conv has a bias

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        from repro_torch.models.registry import count_params
        return count_params(self)

    @property
    def n_active_params(self) -> int:
        from repro_torch.models.registry import count_params
        return count_params(self, active_only=True)

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One dry-run / training cell."""
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode
    num_microbatches: int = 1
    remat: str = "full"              # full | none
    param_dtype: str = "float32"     # train: fp32 master; serve: bf16
    compute_dtype: str = "bfloat16"
    attn_impl: str = "auto"          # auto | ref | chunked | flash (pallas)
    attn_chunk: int = 512            # q-row chunk for chunked attention
    shard_moe_tokens: bool = False   # hillclimb: shard_map all_to_all dispatch
    chunked_ce: int = 0              # hillclimb: vocab-chunked cross-entropy
    fsdp: str = "auto"               # auto|on|off: shard params over "data"
                                     # (ZeRO-3 in-pod); auto: train always,
                                     # serve when params/chip > 3 GB
    ssm_chunk: int = 128             # SSD intra-chunk length (mamba2):
                                     # memory & intra flops scale ~linearly
    grad_reduce_dtype: str = "float32"  # bf16 halves the grad RS volume
    windowed_cache: bool = False     # local-attn layers keep a ring buffer
                                     # of `window` keys instead of full S

    def fsdp_enabled(self, param_bytes_per_model_shard: int = 0) -> bool:
        if self.fsdp == "on":
            return True
        if self.fsdp == "off":
            return False
        if self.kind == "train":
            return True
        return param_bytes_per_model_shard > 3 << 30


SHAPES = {
    "train_4k":    RunConfig(seq_len=4096,   global_batch=256, kind="train",
                             num_microbatches=4),
    "prefill_32k": RunConfig(seq_len=32768,  global_batch=32,  kind="prefill",
                             param_dtype="bfloat16"),
    "decode_32k":  RunConfig(seq_len=32768,  global_batch=128, kind="decode",
                             param_dtype="bfloat16"),
    "long_500k":   RunConfig(seq_len=524288, global_batch=1,   kind="decode",
                             param_dtype="bfloat16"),
}
