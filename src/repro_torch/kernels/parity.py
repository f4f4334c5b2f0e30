"""XOR parity (raid5/SNS erasure code, paper ch. 15) on the card.

`xor_parity(blocks)` is the bitwise XOR of the K rows of an int32
(K, N) tensor; `reconstruct(survivors, parity)` recovers the one missing
row as the XOR of the survivors and the parity.  On a CUDA tensor both
launch the hand-written kernel of `csrc/xor_parity.cu` (on the current
stream, without synchronising); on a CPU tensor they compute the plain
version of `ref.py`.  There is no other route: a CUDA tensor that the
kernel cannot take raises.

LAUNCHES counts the kernel launches, so a run can show that its data
path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LAUNCHES = 0
_launch = None


def _launcher():
    global _launch
    if _launch is None:
        fn = _build.load("xor_parity").xor_parity_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check(blocks: torch.Tensor):
    if blocks.dtype != torch.int32:
        raise TypeError(f"xor_parity wants int32 lanes, got {blocks.dtype}")
    if blocks.dim() != 2 or blocks.shape[0] < 1 or blocks.shape[1] < 1:
        raise ValueError(f"xor_parity wants (K>=1, N>=1), got "
                         f"{tuple(blocks.shape)}")
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"xor_parity runs on cpu or cuda, not "
                         f"{blocks.device}")


def xor_parity(blocks: torch.Tensor) -> torch.Tensor:
    """blocks (K, N) int32 -> parity (N,) int32, for any K, N >= 1."""
    global LAUNCHES
    _check(blocks)
    if blocks.device.type == "cpu":
        return ref.xor_parity_ref(blocks)
    if not blocks.is_contiguous():
        raise ValueError("xor_parity wants a contiguous (K, N) tensor")
    k, n = blocks.shape
    out = torch.empty(n, dtype=torch.int32, device=blocks.device)
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(blocks.data_ptr(), out.data_ptr(), k, n, stream)
    if err != 0:
        raise RuntimeError(f"xor_parity kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def reconstruct(survivors: torch.Tensor,
                parity: torch.Tensor) -> torch.Tensor:
    """Recover the one missing row: XOR(survivors (K-1, N), parity (N,)).
    The same kernel as `xor_parity`, over the K stacked rows."""
    if survivors.dim() != 2 or parity.shape != survivors.shape[1:]:
        raise ValueError(f"reconstruct wants (K-1, N) survivors and (N,) "
                         f"parity, got {tuple(survivors.shape)} and "
                         f"{tuple(parity.shape)}")
    return xor_parity(torch.cat([survivors, parity[None]], 0))
