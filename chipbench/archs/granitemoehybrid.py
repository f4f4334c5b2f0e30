"""Granite 4.0-H (`granitemoehybrid`): the published keys as the port's
ModelConfig and RunConfig of a prefill, the step's cache as the
reference (`ref/granite_hybrid.py`) keeps it, and what the metrics count.

Counts, as `chipbench/count` counts the other models: 2 operations per
multiply-add of a matrix product applied to a token, experts at
`num_experts_per_tok`, the shared expert at every token, the router, the
tied head at each prompt's last position only; no attention scores, SSD
or embedding gather in a model's operations.  A kernel's bound counts its
own work.
"""
from __future__ import annotations

from chipbench import count

REF = "granite_hybrid"          # the reference module, under chipbench/ref/

# base-2 exponentials an SM completes a clock (CUDA C++ Programming Guide,
# compute capability 9.0: 16), at the H100 SXM's 132 SMs and its largest
# SM clock, 1980 MHz
EXP_PER_S = 16 * 132 * 1980e6


def _mamba_dims(cfg: dict):
    """(d_inner, heads, head dim, state size, groups)."""
    d_in = cfg["mamba_expand"] * cfg["hidden_size"]
    return (d_in, cfg["mamba_n_heads"], cfg["mamba_d_head"],
            cfg["mamba_d_state"], cfg["mamba_n_groups"])


def model_config(cfg: dict):
    from repro_torch.models.config import ModelConfig
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    d_in, heads, P, N, _ = _mamba_dims(cfg)
    return ModelConfig(
        name=cfg["port"]["name"], family="granite_hybrid",
        n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=H,
        n_kv_heads=cfg["num_key_value_heads"], head_dim=d // H,
        vocab=cfg["vocab_size"], rope_theta=0.0,
        norm_eps=cfg["rms_norm_eps"], n_experts=cfg["num_local_experts"],
        top_k=cfg["num_experts_per_tok"], d_ff_expert=cfg["intermediate_size"],
        capacity_factor=cfg["capacity_factor"], ssm_state=N, d_inner=d_in,
        ssm_head_dim=P, conv_width=cfg["mamba_d_conv"], act="silu",
        tie_embeddings=cfg["tie_word_embeddings"],
        layer_types=tuple(cfg["layer_types"]),
        embed_mult=float(cfg["embedding_multiplier"]),
        residual_mult=float(cfg["residual_multiplier"]),
        attn_scale=float(cfg["attention_multiplier"]),
        logits_scale=float(cfg["logits_scaling"]),
        d_ff_shared=cfg["shared_intermediate_size"],
        conv_bias=cfg["mamba_conv_bias"])


def prefill_run(cfg: dict):
    from repro_torch.models.config import RunConfig
    run = cfg["run"]
    return RunConfig(seq_len=0, global_batch=1, kind="prefill",
                     param_dtype=run["param_dtype"],
                     compute_dtype=run["compute_dtype"],
                     attn_impl=run["attn_impl"],
                     ssm_chunk=cfg["mamba_chunk_size"], fsdp="off")


def program_cache(cfg: dict, cache: dict) -> dict:
    """The step's cache as per-layer lists, in the reference's order."""
    return {k: list(cache[k][:, 0]) for k in ("conv", "state", "k", "v")}


def layers_of(cfg: dict, kind: str) -> int:
    return cfg["layer_types"].count(kind)


def head_params(cfg: dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def layer_params(cfg: dict) -> int:
    """Matrix-product parameters applied to one token by the layers."""
    d = cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // H
    d_in, heads, _, N, G = _mamba_dims(cfg)
    mamba = d * (2 * d_in + 2 * G * N + heads) + d_in * d
    attn = d * H * dh * 2 + d * Hkv * dh * 2
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    moe = (d * E + k * 3 * d * cfg["intermediate_size"]
           + 3 * d * cfg["shared_intermediate_size"])
    return (layers_of(cfg, "mamba") * mamba
            + layers_of(cfg, "attention") * attn
            + cfg["num_hidden_layers"] * moe)


def prefill_flops(cfg: dict, tokens: int, requests: int = 1) -> float:
    return 2.0 * (layer_params(cfg) * tokens + head_params(cfg) * requests)


def attention_shape(cfg: dict) -> tuple[int, int, int]:
    H = cfg["num_attention_heads"]
    return H, cfg["num_key_value_heads"], cfg["hidden_size"] // H


def ssd_cost(cfg: dict, S: int, B: int = 1) -> dict:
    """One block's SSD over S positions in chunks of `mamba_chunk_size`:
    its bytes (x, B, C, da, dt read once; y in float32 and the final
    state written once), the products it needs (C B^T once a chunk and
    att x over the kept pairs of the lower triangles, the chunk states,
    C S_{c-1} past the first chunk) and one exponential a kept pair."""
    _, H, P, N, _ = _mamba_dims(cfg)
    Q = cfg["mamba_chunk_size"]
    nc = S // Q
    kept = Q * (Q + 1) // 2
    nbytes = (B * S * H * P * (2 + 4) + 2 * B * S * N * 2
              + 2 * B * S * H * 4 + B * H * N * P * 4)
    flops = (2 * B * nc * kept * (N + H * P) + 2 * B * S * H * N * P
             + 2 * B * (S - Q) * H * N * P)
    return {"bytes": nbytes, "flops": flops, "exps": B * nc * H * kept}


def ssd_bound_s(cfg: dict, S: int) -> float:
    """The least time of one block's SSD: the largest of its bytes at the
    memory's rate, its products at the bf16 peak and its exponentials at
    EXP_PER_S."""
    c = ssd_cost(cfg, S)
    return max(c["bytes"] / count.PEAK_BYTES_PER_S,
               c["flops"] / count.PEAK_FLOPS["bfloat16"],
               c["exps"] / EXP_PER_S)
