"""A configuration file's published keys, as the port's ModelConfig and
RunConfig of a prefill: the one place where the benchmark names the
program's configuration fields."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig, RunConfig


def model_config(cfg: dict) -> ModelConfig:
    kind = cfg["model_type"]
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    common = dict(n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=H,
                  n_kv_heads=cfg["num_key_value_heads"],
                  vocab=cfg["vocab_size"], rope_theta=cfg["rope_theta"],
                  norm_eps=cfg["rms_norm_eps"])
    if kind == "phimoe":
        f = cfg["intermediate_size"]
        return ModelConfig(
            name=cfg["port"]["name"], family="transformer",
            head_dim=d // H, d_ff=f, n_experts=cfg["num_local_experts"],
            top_k=cfg["num_experts_per_tok"], d_ff_expert=f, act="silu",
            capacity_factor=cfg["capacity_factor"], **common)
    if kind == "zamba2":
        return ModelConfig(
            name=cfg["port"]["name"], family="zamba2",
            head_dim=cfg["kv_channels"], d_ff=cfg["ffn_hidden_size"],
            ssm_state=cfg["mamba_d_state"],
            d_inner=cfg["mamba_expand"] * d,
            ssm_head_dim=cfg["mamba_headdim"],
            conv_width=cfg["mamba_d_conv"], attn_every=cfg["port"]["group"],
            act="gelu", **common)
    raise ValueError(f"no port mapping for model_type {kind!r}")


def prefill_run(cfg: dict) -> RunConfig:
    run = cfg["run"]
    return RunConfig(seq_len=0, global_batch=1, kind="prefill",
                     param_dtype=run["param_dtype"],
                     compute_dtype=run["compute_dtype"],
                     attn_impl=run["attn_impl"],
                     ssm_chunk=cfg.get("chunk_size", 128), fsdp="off")
