"""XOR parity (raid5/SNS erasure code, paper ch. 15) on the card.

`xor_parity(blocks)` is the bitwise XOR of the K rows of an int32
(K, N) tensor; `reconstruct(survivors, parity)` recovers the one missing
row as the XOR of the survivors and the parity.  On CUDA tensors both
launch the hand-written kernel of `csrc/xor_parity.cu` once (on the
current stream, without synchronising), handing it a pointer to each
row: rows may lie anywhere (any row stride, separate tensors), and
`reconstruct` concatenates nothing.  On CPU tensors they compute the
plain version of `ref.py`.  There is no other route: a CUDA tensor that
the kernel cannot take raises.

LAUNCHES counts the kernel launches, so a run can show that its data
path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LAUNCHES = 0
MAX_ROWS_BY_VALUE = 16        # more rows pass their pointers in card memory
_launch = None


def _launcher():
    global _launch
    if _launch is None:
        fn = _build.load("xor_parity").xor_rows_launch
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check(t: torch.Tensor, dim: int):
    if t.dtype != torch.int32:
        raise TypeError(f"xor_parity wants int32 lanes, got {t.dtype}")
    if t.dim() != dim or min(t.shape) < 1:
        raise ValueError(f"xor_parity wants a {dim}-d tensor of sizes >= 1 "
                         f"(K rows of N lanes), got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"xor_parity runs on cpu or cuda, not {t.device}")
    if t.device.type == "cuda" and t.stride(-1) != 1:
        raise ValueError("xor_parity wants the lanes of a row contiguous")


def _launch_rows(ptrs: list[int], n: int,
                 dev: torch.device) -> torch.Tensor:
    """One launch over the rows at `ptrs`, each N int32 lanes on `dev`."""
    global LAUNCHES
    k = len(ptrs)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    # beyond MAX_ROWS_BY_VALUE the kernel reads the pointers from the card;
    # the caching allocator keeps this block for the launch's stream
    many = torch.tensor(ptrs, dtype=torch.int64).to(dev) \
        if k > MAX_ROWS_BY_VALUE else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()((ctypes.c_void_p * k)(*ptrs), k,
                          None if many is None else many.data_ptr(),
                          out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"xor_parity kernel launch failed (K={k}, "
                           f"N={n}): CUDA error {err}")
    LAUNCHES += 1
    return out


def xor_parity(blocks: torch.Tensor) -> torch.Tensor:
    """blocks (K, N) int32 -> parity (N,) int32, for any K, N >= 1.  On
    the card the rows may have any stride; the lanes of a row must be
    contiguous."""
    _check(blocks, 2)
    if blocks.device.type == "cpu":
        return ref.xor_parity_ref(blocks)
    k, n = blocks.shape
    step = blocks.stride(0) * 4
    return _launch_rows([blocks.data_ptr() + i * step for i in range(k)], n,
                        blocks.device)


def reconstruct(survivors, parity: torch.Tensor) -> torch.Tensor:
    """Recover the one missing row: XOR(survivors, parity (N,)).
    `survivors` is a (K-1, N) tensor or a sequence of (N,) rows; on the
    card one launch reads each row where it lies."""
    if isinstance(survivors, torch.Tensor):
        if survivors.dim() != 2:
            raise ValueError(f"reconstruct wants (K-1, N) survivors, got "
                             f"{tuple(survivors.shape)}")
        survivors = list(survivors.unbind(0))
    _check(parity, 1)
    for row in survivors:
        _check(row, 1)
        if row.shape != parity.shape or row.device != parity.device:
            raise ValueError(f"reconstruct wants survivors of shape "
                             f"{tuple(parity.shape)} on {parity.device}, "
                             f"got {tuple(row.shape)} on {row.device}")
    if parity.device.type == "cpu":
        return ref.reconstruct_ref(survivors, parity)
    return _launch_rows([r.data_ptr() for r in survivors] +
                        [parity.data_ptr()], parity.shape[0], parity.device)
