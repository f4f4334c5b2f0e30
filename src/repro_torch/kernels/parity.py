"""XOR parity (raid5/SNS erasure code, paper ch. 15) on the card.

`xor_parity(blocks)` is the bitwise XOR of the K rows of a (K, N) tensor
of any integer type (`ROW_TYPES`), stored as N int32 lanes as the Pallas
kernel stores it: signed types sign-extended, unsigned ones
zero-extended, 32-bit ones by their bits, 64-bit ones by their low 32
bits (`ref.to_int32`).  `reconstruct(survivors, parity)` recovers the one
missing row as the XOR of the survivors and the parity (the parity is
typically `xor_parity`'s int32 output beside survivors of the row type).
On CUDA tensors both launch the hand-written kernel of
`csrc/xor_parity.cu` (on the current stream, without synchronising),
handing it a pointer to each row: rows may lie anywhere (any row stride,
separate tensors), and `reconstruct` concatenates nothing.  One launch
takes rows of one type; `reconstruct` launches once for each type among
its rows and, when there are several, once more over their int32 results.
On CPU tensors they compute the plain version of `ref.py`.  There is no
other route: a CUDA tensor that the kernel cannot take raises.

LAUNCHES counts the kernel launches, so a run can show that its data
path went through the kernel, and TYPE_LAUNCHES those of each row type,
keyed by its name ("int32", "uint8", ...).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

LAUNCHES = 0
TYPE_LAUNCHES: dict[str, int] = {}
MAX_ROWS_BY_VALUE = 16        # more rows pass their pointers in card memory
# the row types, in the order of the launcher's element codes (the
# unsigned 32- and 64-bit types share the kernels of their signed twins)
ROW_TYPES = (torch.int8, torch.uint8, torch.int16, torch.uint16, torch.int32,
             torch.int64, torch.uint32, torch.uint64)
_ELEM_CODE = {t: i for i, t in enumerate(ROW_TYPES[:6])} | {
    torch.uint32: 4, torch.uint64: 5}
_launch = None


def _launcher():
    global _launch
    if _launch is None:
        fn = _build.load("xor_parity").xor_rows_launch
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check(t: torch.Tensor, dim: int):
    if t.dtype not in ROW_TYPES:
        raise TypeError(f"xor_parity wants rows of an integer type, got "
                        f"{t.dtype}")
    if t.dim() != dim or min(t.shape) < 1:
        raise ValueError(f"xor_parity wants a {dim}-d tensor of sizes >= 1 "
                         f"(K rows of N lanes), got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"xor_parity runs on cpu or cuda, not {t.device}")
    if t.device.type == "cuda" and t.stride(-1) != 1:
        raise ValueError("xor_parity wants the lanes of a row contiguous")


def _launch_rows(ptrs: list[int], n: int, dtype: torch.dtype,
                 dev: torch.device) -> torch.Tensor:
    """One launch over the rows at `ptrs`, each N elements of `dtype` on
    `dev`: their XOR as N int32 lanes."""
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
                          out.data_ptr(), n, _ELEM_CODE[dtype], stream)
    if err != 0:
        raise RuntimeError(f"xor_parity kernel launch failed (K={k}, "
                           f"N={n}, {dtype}): CUDA error {err}")
    LAUNCHES += 1
    name = str(dtype).removeprefix("torch.")
    TYPE_LAUNCHES[name] = TYPE_LAUNCHES.get(name, 0) + 1
    return out


def xor_parity(blocks: torch.Tensor) -> torch.Tensor:
    """blocks (K, N) of an integer type -> parity (N,) int32, for any K,
    N >= 1.  On the card the rows may have any stride; the elements of a
    row must be contiguous."""
    _check(blocks, 2)
    if blocks.device.type == "cpu":
        return ref.xor_parity_ref(blocks)
    k, n = blocks.shape
    step = blocks.stride(0) * blocks.element_size()
    return _launch_rows([blocks.data_ptr() + i * step for i in range(k)], n,
                        blocks.dtype, blocks.device)


def reconstruct(survivors, parity: torch.Tensor) -> torch.Tensor:
    """Recover the one missing row: XOR(survivors, parity (N,)) as N int32
    lanes.  `survivors` is a (K-1, N) tensor or a sequence of (N,) rows,
    each row of any integer type; on the card a launch reads each row
    where it lies."""
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
    rows = survivors + [parity]
    n, dev = parity.shape[0], parity.device
    by_type: dict[int, list[torch.Tensor]] = {}
    for row in rows:
        by_type.setdefault(_ELEM_CODE[row.dtype], []).append(row)
    if len(by_type) == 1:
        return _launch_rows([r.data_ptr() for r in rows], n, parity.dtype,
                            dev)
    # each type's XOR in int32, then the XOR of those (the stores to int32
    # are bitwise, so this is the XOR of the rows stored in int32)
    parts = [_launch_rows([r.data_ptr() for r in group], n, group[0].dtype,
                          dev) for group in by_type.values()]
    return _launch_rows([p.data_ptr() for p in parts], n, torch.int32, dev)
