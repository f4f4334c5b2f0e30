"""Per-architecture configs (exact public configs; see inline citations)."""
from __future__ import annotations

import importlib

ARCHS = [
    "yi-9b", "gemma3-12b", "qwen3-4b", "qwen2-7b", "paligemma-3b",
    "phi3.5-moe", "dbrx-132b", "rwkv6-3b", "whisper-tiny", "zamba2-7b",
]

_MOD = {
    "yi-9b": "yi_9b", "gemma3-12b": "gemma3_12b", "qwen3-4b": "qwen3_4b",
    "qwen2-7b": "qwen2_7b", "paligemma-3b": "paligemma_3b",
    "phi3.5-moe": "phi35_moe", "dbrx-132b": "dbrx_132b",
    "rwkv6-3b": "rwkv6_3b", "whisper-tiny": "whisper_tiny",
    "zamba2-7b": "zamba2_7b",
}


def get_config(name: str):
    return importlib.import_module(f"repro_torch.configs.{_MOD[name]}").CONFIG


def get_smoke_config(name: str):
    return importlib.import_module(f"repro_torch.configs.{_MOD[name]}").SMOKE
