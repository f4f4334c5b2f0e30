"""Plain PyTorch versions of the port's kernels (XOR parity, flash
attention).

The kernel wrappers fall back to these only for tensors on the CPU; the
tests hold them against the JAX reference and `chip_smoke.py` holds each
CUDA kernel against them on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None,
                        block_k: int = 128) -> torch.Tensor:
    """q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (B,H,Sq,D) in q's dtype.

    The flash-attention kernel's function, computed as the kernel does:
    a loop over tiles of `block_k` keys with a running max, sum and
    accumulator in float32.  Query position i sits at i + Sk - Sq (causal
    aligned bottom-right); a key is kept when it is not in the future
    (causal) and `qpos - kpos < window` (window > 0, causal or not).  A
    row that keeps no key is 0.  Query head h reads key/value head
    h // (H // Hkv).  q, k, v may be any strided views (the kernel's
    (B,S,H,D)-transposed inputs among them); the result is contiguous."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    bk = min(block_k, Sk)
    dev = q.device
    qf = q.reshape(B, Hkv, G, Sq, D).float()
    qpos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    m = torch.full((B, Hkv, G, Sq, 1), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G, Sq, 1), device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=dev)
    for k0 in range(0, Sk, bk):
        k1 = min(k0 + bk, Sk) - 1
        # skip a tile that is outside every query's window, as the kernel
        # does (decided on the host, so the loop can be graph-captured);
        # the last query (position Sk - 1) sees every tile causally
        if window > 0 and (Sk - Sq) - k1 >= window:
            continue
        kpos = torch.arange(k0, k1 + 1, device=dev)[None, :]
        keep = torch.ones((Sq, kpos.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            keep &= kpos <= qpos
        if window > 0:
            keep &= (qpos - kpos) < window
        kt = k[:, :, k0:k0 + bk].float()
        vt = v[:, :, k0:k0 + bk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * scale
        s = s.masked_fill(~keep, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new).masked_fill(~keep, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vt)
        m = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.reshape(B, H, Sq, D).to(q.dtype)


def xor_parity_ref(blocks: torch.Tensor) -> torch.Tensor:
    """blocks (K, N) int32 lanes -> (N,) XOR parity (RAID-5 column)."""
    out = blocks[0].clone()
    for i in range(1, blocks.shape[0]):
        out.bitwise_xor_(blocks[i])
    return out


def reconstruct_ref(survivors: torch.Tensor,
                    parity: torch.Tensor) -> torch.Tensor:
    """Recover one missing block: XOR of the survivors and the parity."""
    out = parity.clone()
    for row in survivors:
        out.bitwise_xor_(row)
    return out
