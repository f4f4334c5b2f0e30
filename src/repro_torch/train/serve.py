"""Batched serving: lockstep batched decode.

A wave of requests is left-padded to a common prompt length and decoded in
lockstep, one decode step per token for the whole batch, prompt included:
the logic of `repro.train.serve`, on the card by default.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig, RunConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Serve one wave of B requests in lockstep on `device`."""

    def __init__(self, cfg: ModelConfig, params, *, max_seq: int = 256,
                 eos: int = -1, pad: int = 0, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.eos = eos
        self.pad = pad
        self.device = resolve_device(device)
        self.rc = RunConfig(seq_len=max_seq, global_batch=0, kind="decode",
                            param_dtype="float32", attn_impl="ref")

    def _decode(self, cache, token: np.ndarray, pos: int):
        t = torch.from_numpy(token).to(self.device)
        with torch.no_grad():
            return registry.decode(self.cfg, self.params, cache, t, pos,
                                   self.rc)

    def _fresh_cache(self, batch: int):
        spec = registry.init_cache(self.cfg, batch, self.max_seq,
                                   getattr(torch, self.rc.compute_dtype))
        return {k: torch.zeros(shape, dtype=dt, device=self.device)
                for k, (shape, dt) in spec.items()}

    def generate(self, requests: list[Request]) -> list[Request]:
        B = len(requests)
        plen = max(len(r.prompt) for r in requests)
        toks = np.full((B, plen), self.pad, np.int32)
        for i, r in enumerate(requests):
            # left-pad so every prompt ends at the same position
            toks[i, plen - len(r.prompt):] = r.prompt
        cache = self._fresh_cache(B)
        # prefill via lockstep single-token decode
        last = None
        for j in range(plen):
            last, cache = self._decode(cache, toks[:, j:j + 1], j)
        nxt = torch.argmax(last, dim=-1).reshape(-1).cpu().numpy()
        max_new = max(r.max_new for r in requests)
        for step in range(max_new):
            for i, r in enumerate(requests):
                if not r.done and len(r.out) < r.max_new:
                    r.out.append(int(nxt[i]))
                    if int(nxt[i]) == self.eos or \
                            len(r.out) >= r.max_new:
                        r.done = True
            if all(r.done for r in requests):
                break
            pos = plen + step
            if pos >= self.max_seq - 1:
                break
            logits, cache = self._decode(
                cache, nxt.reshape(B, 1).astype(np.int32), pos)
            nxt = torch.argmax(logits, dim=-1).reshape(-1).cpu().numpy()
        for r in requests:
            r.done = True
        return requests
