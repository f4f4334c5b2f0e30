"""The yardstick: operations and bytes computed from shapes, and the card's
published peaks (NVIDIA H100 SXM data sheet, dense, at a 700 W limit).

These are copies of the arithmetic a model's MFU and a kernel's roofline
need, kept with the benchmark so that a change to the program cannot move
them.  Counts follow the convention of the MFU literature: 2 operations per
multiply-add of a matrix product applied to a token (6 in training);
embedding gathers and the attention scores themselves are not counted in a
model's operations, while a kernel's bound counts its own work.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float8": 1979e12,
              "tf32": 494.7e12, "float32": 66.9e12}
PEAK_BYTES_PER_S = 3.35e12


def head_params(cfg: dict) -> int:
    """The output head's matrix-product parameters."""
    return cfg["hidden_size"] * cfg["vocab_size"]


def matmul_params(cfg: dict) -> int:
    """Matrix-product parameters applied to one token in a forward pass,
    from the configuration file's published keys: experts counted at
    `num_experts_per_tok`, a block whose weights are shared counted once
    for each time it is applied, the output head counted, the embedding
    gather not."""
    return layer_params(cfg) + head_params(cfg)


def layer_params(cfg: dict) -> int:
    """`matmul_params` without the output head."""
    kind = cfg["model_type"]
    d = cfg["hidden_size"]
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    if kind == "phimoe":
        dh = d // H
        attn = d * H * dh * 2 + d * Hkv * dh * 2
        E, k, f = (cfg["num_local_experts"], cfg["num_experts_per_tok"],
                   cfg["intermediate_size"])
        per_layer = attn + d * E + k * 3 * d * f
        return cfg["num_hidden_layers"] * per_layer
    if kind == "zamba2":
        dh = cfg["kv_channels"]
        d_in = cfg["mamba_expand"] * d
        heads = d_in // cfg["mamba_headdim"]
        N = cfg["mamba_d_state"]
        # as run: one group of B and C (see the file's `departures`)
        mamba = d * (2 * d_in + 2 * N + heads) + d_in * d
        shared = d * H * dh * 2 + d * Hkv * dh * 2 + 3 * d * cfg[
            "ffn_hidden_size"]
        applications = len(cfg["hybrid_layer_ids"])
        return cfg["num_hidden_layers"] * mamba + applications * shared
    raise ValueError(f"no count for model_type {kind!r}")


def prefill_flops(cfg: dict, tokens: int, requests: int = 1) -> float:
    """A prefill of `requests` prompts of `tokens` tokens in all: every
    layer over every token, the head over each prompt's last position
    only (the step unembeds the next token alone)."""
    return 2.0 * (layer_params(cfg) * tokens + head_params(cfg) * requests)


def attention_layers(cfg: dict) -> int:
    """Launches of the attention kernel in one prefill."""
    if cfg["model_type"] == "zamba2":
        return len(cfg["hybrid_layer_ids"])
    return cfg["num_hidden_layers"]


def attention_shape(cfg: dict) -> tuple[int, int, int]:
    """(heads, kv heads, head dim) of the attention kernel's launches."""
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    if cfg["model_type"] == "zamba2":
        return H, Hkv, cfg["kv_channels"]
    return H, Hkv, cfg["hidden_size"] // H


def flash_bound_s(B: int, H: int, Hkv: int, S: int, D: int,
                  itemsize: int = 2, dtype: str = "bfloat16") -> float:
    """The least time of one causal attention launch: the larger of its
    products (Q K^T and P V over the S(S+1)/2 kept pairs, 4 H D a pair)
    at the peak and its bytes (q, k, v read once, o written once) at the
    memory's rate."""
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def xor_lanes(row_bytes: int) -> int:
    """int32 lanes of a row of `row_bytes` bytes laid out for the XOR
    kernel: whole 16-byte groups."""
    return -(-row_bytes // 16) * 4


def xor_bound_s(K: int, lanes: int, itemsize: int = 4) -> float:
    """The least time of one XOR launch over K rows: K rows read, one
    written, at the memory's rate."""
    return (K + 1) * lanes * itemsize / PEAK_BYTES_PER_S


def stripe_rows(nbytes: int, stripe_size: int, stripe_count: int
                ) -> list[int]:
    """The byte length of each non-empty stripe column (one per object) of
    a RAID-0 striped file of `nbytes` bytes."""
    full, rem = divmod(nbytes, stripe_size)
    rows = []
    for i in range(stripe_count):
        units = full // stripe_count + (1 if i < full % stripe_count else 0)
        n = units * stripe_size + (rem if i == full % stripe_count else 0)
        if n:
            rows.append(n)
    return rows


def train_flops(cfg: dict, tokens: int) -> float:
    """Forward and backward: 6 operations a parameter a token (the
    recomputation of remat not counted)."""
    return 6.0 * matmul_params(cfg) * tokens
