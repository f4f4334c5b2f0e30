"""Entry points to the port's kernels, as their callers use them.

`flash_attention` is the model's way to the attention kernel, with the
reference's block clamping and divisibility contract.

Stripe units are byte strings of unequal length.  `parity_bytes` lays
them out as the zero-padded rows of an int32 (K, N) array (0 is the XOR
identity, so padding never changes the parity), moves it to `device`,
computes the XOR there and returns the first max(len) bytes.  N is
padded to a multiple of 4 lanes so that every row starts on a 16-byte
boundary and the kernel can take its 16-byte path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import parity as _par


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    block_q=128, block_k=128):
    """q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (B,H,Sq,D).  The blocks are
    clamped to the sequence lengths and must then divide them, as the
    reference's Pallas grid requires; the kernel's own tiles do not
    depend on them.  q, k, v may be strided views; the output has q's
    memory order (see `kernels.flash_attention`)."""
    block_q = min(block_q, q.shape[2])
    block_k = min(block_k, k.shape[2])
    if q.shape[2] % block_q or k.shape[2] % block_k:
        raise ValueError(f"flash_attention: blocks ({block_q}, {block_k}) "
                         f"do not divide Sq={q.shape[2]}, Sk={k.shape[2]}")
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; "cuda" without a usable card raises
    instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is false")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def parity_bytes(chunks: list[bytes], *, device) -> bytes:
    """XOR parity over byte chunks, each zero-padded to the longest."""
    dev = resolve_device(device)
    n = max(len(c) for c in chunks)
    row = -(-n // 16) * 16
    arr = np.zeros((len(chunks), row), np.uint8)
    for i, c in enumerate(chunks):
        arr[i, :len(c)] = np.frombuffer(c, np.uint8)
    blocks = torch.from_numpy(arr.view(np.int32)).to(dev)
    out = _par.xor_parity(blocks).cpu().numpy()
    return out.view(np.uint8).tobytes()[:n]


def reconstruct_bytes(survivors: list[bytes], parity: bytes, length: int,
                      *, device) -> bytes:
    return parity_bytes(survivors + [parity], device=device)[:length]
