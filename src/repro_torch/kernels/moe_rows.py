"""The MoE's dispatch and combine on the card (`csrc/moe_rows.cu`).

`dispatch_rows(x, order, dest, n_experts, C, k)` computes the
(n_experts, C, d) expert buffer that `models.moe._scatter` computes, bit
for bit, from the sort of `models.moe.dispatch` (`order`, `dest`), and
beside it `slot_row` (T*k,) int32: each (token, slot) assignment's buffer
row, -1 where it was dropped.  `combine_rows(out, slot_row, top_p)` takes
the experts' output and that map to y (T, d): each slot's row times its
gate (rounded to the row type, as `_combine` rounds `gathered * w`),
summed over the k slots in slot order in float32 and rounded once.
`_combine` sums the same products in another order on the card, so y
may differ from its y by one unit in the last place where that order
moves a rounding.  Neither kernel synchronises; the wrappers allocate the
outputs and the scratch (slot_row and each expert's fill).

Each has its plain PyTorch version beside it (`dispatch_rows_plain`,
`combine_rows_plain`), which the wrappers take for CPU tensors: the same
map, each buffer row written once from its token or zeroed, the same
products summed in the same order.

`route(x, top_p, cdt)` decides where an MoE layer's dispatch and combine
run: "kernel", or the reason `_scatter` and `_combine` run instead.  The
wrappers raise on a card tensor that `route` would not send to them.
LAUNCHES counts the wrappers' calls on the card (two a layer).
"""
from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build

DTYPES = (torch.bfloat16, torch.float16)   # the row types the kernels take

LAUNCHES = 0
_launch: list = []


def _dense_rows(t: torch.Tensor) -> bool:
    """Rows of 16-byte vectors: the last dimension dense and a multiple
    of 16 bytes, each row (and, for a card tensor, the start) 16-byte
    aligned, and every leading dimension dense over the rows."""
    item = t.element_size()
    if t.stride(-1) != 1 or t.shape[-1] * item % 16:
        return False
    if t.dim() > 2 and not t.is_contiguous():
        return False
    if t.dim() >= 2 and t.shape[-2] > 1 and t.stride(-2) * item % 16:
        return False
    return (t.device.type != "cuda" or isinstance(t, DTensor)
            or t.data_ptr() % 16 == 0)


def _on_card(tensors) -> bool:
    """All plain tensors on one CUDA device."""
    dev = tensors[0].device
    return all(not isinstance(t, DTensor) and t.device.type == "cuda"
               and t.device == dev for t in tensors)


def route(x, top_p, cdt) -> str:
    """"kernel" where `csrc/moe_rows.cu` takes an MoE layer's dispatch and
    combine of x (T, d) (cast to `cdt`, as `_scatter` casts it) with the
    router's top_p (T, k); otherwise the first reason in this order that
    `_scatter` and `_combine` run them:
      "grad"    grad mode is on and x or top_p needs a gradient (the
                kernels have no backward);
      "dtype"   `cdt` not bfloat16 or float16, or top_p not float32;
      "layout"  x's rows (in `cdt`) not 16-byte aligned and dense;
      "device"  not plain tensors on one CUDA device (every CPU tensor,
                and a DTensor, whose dispatch runs under `local_map`)."""
    if torch.is_grad_enabled() and (x.requires_grad or top_p.requires_grad):
        return "grad"
    if cdt not in DTYPES or top_p.dtype != torch.float32:
        return "dtype"
    # a cast is a fresh dense tensor; x in `cdt` is read as it lies
    if x.dim() != 2 or x.shape[-1] * cdt.itemsize % 16 or (
            x.dtype == cdt and not _dense_rows(x)):
        return "layout"
    if not _on_card((x, top_p)):
        return "device"
    return "kernel"


def _why(rows, others) -> str:
    """`route`'s reasons, in its order, for the row tensors `rows` of a
    wrapper beside its index and gate tensors `others`."""
    ins = (*rows, *others)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return "grad"
    if any(t.dtype not in DTYPES for t in rows):
        return "dtype"
    if not all(_dense_rows(t) for t in rows):
        return "layout"
    if not _on_card(ins):
        return "device"
    return "kernel"


def _refuse(what: str, why: str):
    raise ValueError(f"moe_rows {what} does not take these inputs: {why}")


def _launcher():
    """(moe_dispatch_rows, moe_combine_rows) of `csrc/moe_rows.cu`."""
    if not _launch:
        lib = _build.load("moe_rows")
        disp = lib.moe_dispatch_rows
        disp.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [
            ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        disp.restype = ctypes.c_int
        comb = lib.moe_combine_rows
        comb.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        comb.restype = ctypes.c_int
        _launch.extend((disp, comb))
    return _launch


def dispatch_rows_plain(x, order, dest, n_experts: int, C: int, k: int):
    """The dispatch as the kernels compute it, in PyTorch: the map from
    each (token, slot) to its row, each expert's fill from its last kept
    assignment, the rows past a fill zeroed and each kept row written from
    its token.  Returns (buf (n_experts, C, d), slot_row (T*k,) int32)."""
    T, d = x.shape
    rows = n_experts * C
    kept = (dest >= 0) & (dest < rows)
    slot_row = torch.empty(T * k, dtype=torch.int32, device=x.device)
    slot_row[order] = torch.where(kept, dest, -1).to(torch.int32)
    # an expert's kept rows are e C + 0, 1, ... at consecutive sorted
    # positions: the last is the one the next position does not continue
    p = dest % C
    nxt = torch.cat([dest[1:], dest.new_full((1,), -1)])
    last = kept & ((p == C - 1) | (nxt != dest + 1))
    fill = torch.zeros(n_experts, dtype=torch.int64, device=x.device)
    fill[dest[last] // C] = p[last] + 1
    # NaN marks a row neither pass writes; a kept row that the fill
    # counts as empty is zeroed after its token wrote it
    buf = torch.full((rows, d), float("nan"), dtype=x.dtype, device=x.device)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    mine = slot_row >= 0
    buf[slot_row[mine].long()] = x[tok[mine]]
    r = torch.arange(rows, device=x.device)
    buf[r % C >= fill[r // C]] = 0
    return buf.reshape(n_experts, C, d), slot_row


def dispatch_rows(x, order, dest, n_experts: int, C: int, k: int):
    """The (n_experts, C, d) expert buffer of x (T, d) in a row type of
    DTYPES and the (T*k,) int32 slot_row map, on the card (`dispatch_rows_
    plain` for CPU tensors)."""
    global LAUNCHES
    if not isinstance(x, DTensor) and x.device.type == "cpu":
        return dispatch_rows_plain(x, order, dest, n_experts, C, k)
    T, d = x.shape
    why = _why((x,), (order, dest))
    if why != "kernel":
        _refuse("dispatch", why)
    if not all(t.dtype == torch.int64 and t.shape == (T * k,)
               and t.is_contiguous() for t in (order, dest)):
        _refuse("dispatch", "order and dest not dense (T*k,) int64")
    buf = torch.empty((n_experts, C, d), dtype=x.dtype, device=x.device)
    scratch = torch.empty(T * k + n_experts, dtype=torch.int32,
                          device=x.device)
    launch = _launcher()[0]
    item = x.element_size()
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), (x.stride(0) if T > 1 else d) * item,
                     order.data_ptr(), dest.data_ptr(), buf.data_ptr(),
                     scratch.data_ptr(), T, k, n_experts, C, d * item,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_rows dispatch launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return buf, scratch[:T * k]


def combine_rows_plain(out, slot_row, top_p):
    """The combine as the kernel computes it, in PyTorch: each slot's row
    (a zero row where it was dropped) times its gate in the row type,
    summed over the slots in order in float32, rounded once."""
    E, C, d = out.shape
    T, k = top_p.shape
    flat = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))])
    rows = torch.where(slot_row >= 0, slot_row, E * C).long()
    prod = (flat[rows] * top_p.reshape(-1, 1).to(out.dtype)).reshape(T, k, d)
    acc = torch.zeros((T, d), dtype=torch.float32, device=out.device)
    for j in range(k):
        acc += prod[:, j].float()
    return acc.to(out.dtype)


def combine_rows(out, slot_row, top_p):
    """y (T, d) in out's type from the experts' output (E, C, d), the
    slot_row map of `dispatch_rows` and top_p (T, k) float32, on the card
    (`combine_rows_plain` for CPU tensors)."""
    global LAUNCHES
    if not isinstance(out, DTensor) and out.device.type == "cpu":
        return combine_rows_plain(out, slot_row, top_p)
    E, C, d = out.shape
    T, k = top_p.shape
    why = _why((out,), (slot_row, top_p))
    if why != "kernel":
        _refuse("combine", why)
    if not (slot_row.dtype == torch.int32 and slot_row.shape == (T * k,)
            and slot_row.is_contiguous() and top_p.dtype == torch.float32
            and top_p.is_contiguous()):
        _refuse("combine", "slot_row not dense (T*k,) int32 or top_p not "
                "dense float32")
    y = torch.empty((T, d), dtype=out.dtype, device=out.device)
    launch = _launcher()[1]
    item = out.element_size()
    with torch.cuda.device(out.device):
        err = launch(out.data_ptr(), slot_row.data_ptr(), top_p.data_ptr(),
                     y.data_ptr(), T, k, d * item,
                     int(out.dtype == torch.float16),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_rows combine launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return y
