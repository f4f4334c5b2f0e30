"""The serving steps: prefill_step and serve_step (decode).

The counterparts of `build_prefill_step` and `build_serve_step` of
`repro.train.steps`, as plain callables on an explicit device.  PyTorch
runs eagerly, so there is nothing to lower: no ShapeDtypeStructs, no
shardings, no StepBundle (the dry-run tooling is ROADMAP Queue 1 item 11).
The train step is Queue 1 item 5.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig, RunConfig


def _on(dev: torch.device, params):
    """Raise unless the parameters lie on `dev`."""
    got = params["embed"].device
    if got.type != dev.type or (dev.index is not None
                                and got.index != dev.index):
        raise ValueError(f"parameters lie on {got}, the step runs on {dev}")


def build_prefill_step(cfg: ModelConfig, rc: RunConfig, device="cuda"):
    """step(params, batch) -> (next_tok (B,1) int32, cache {"k","v"}).

    Runs the full-sequence forward over batch["tokens"] (B,S), keeping
    each layer's K/V, and takes the argmax of the last position's
    logits."""
    dev = resolve_device(device)

    def step(params, batch):
        _on(dev, params)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad():
            x, _, cache, _, _ = registry.forward(cfg, params, batch, rc,
                                                 return_cache=True)
            logits = registry.unembed(cfg, params, x[:, -1:], rc)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache

    return step


def build_serve_step(cfg: ModelConfig, rc: RunConfig, device="cuda"):
    """step(params, cache, token (B,1), pos) -> (next_tok (B,1) int32,
    cache): one-token decode against a seq_len KV cache, written in
    place."""
    dev = resolve_device(device)

    def step(params, cache, token, pos):
        _on(dev, params)
        token = torch.as_tensor(token, device=dev)
        with torch.no_grad():
            logits, cache = registry.decode(cfg, params, cache, token,
                                            int(pos), rc)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache

    return step
