"""Plain PyTorch versions of the port's kernels.

The kernel wrappers fall back to these only for tensors on the CPU; the
tests hold them against the JAX reference and `chip_smoke.py` holds each
CUDA kernel against them on the card."""
from __future__ import annotations

import torch


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
