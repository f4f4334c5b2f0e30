"""The chunked SSD of a Mamba2 prefill on the card (`csrc/ssd.cu`).

`ssd_chunked(xh, Bm, Cm, da, dt, chunk)` computes what
`models.zamba2._ssd_chunked(xh, Bm, Cm, da, dt, chunk, torch.bfloat16)`
computes, with the same rounding points, without any (B, nc, Q, Q, H)
tensor in device memory: xh (B, S, H, P) bfloat16, Bm and Cm (B, S, N)
bfloat16, da and dt (B, S, H) float32 -> y (B, S, H, P) float32 and the
final state (B, H, N, P) float32.  Four kernels of `csrc/ssd.cu` run on
the current stream without synchronising; the wrapper allocates the
outputs and their scratch (each position's cumsum, dt and state weight,
each chunk's state).

`route(...)` decides where a block's SSD runs: "kernel", or the reason
the plain version (`_ssd_chunked`, which every CPU tensor takes) runs
instead.  The wrapper raises on anything `route` does not send to the
kernel.  LAUNCHES counts the wrapper's calls (one a block's SSD).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

CHUNKS = (16, 32, 64, 128, 256)  # the chunk lengths the kernel takes
# the (N, P) pairs it takes: zamba2's and Granite 4.0-H's state and head dim
DIMS = ((64, 64), (128, 64))

LAUNCHES = 0
_launch: list = []


def _aligned(t: torch.Tensor, dims: range) -> bool:
    """16-byte rows for cp.async: the last dimension dense and the start
    (of a CUDA tensor: nothing else has a card address) and every other
    stride (of a dimension longer than 1) 16 bytes."""
    item = t.element_size()
    return (t.stride(-1) == 1
            and (t.device.type != "cuda" or t.data_ptr() % 16 == 0)
            and all(t.shape[d] == 1 or t.stride(d) * item % 16 == 0
                    for d in dims))


def route(xh, Bm, Cm, da, dt, chunk: int, cdt) -> str:
    """"kernel" where `csrc/ssd.cu` takes these inputs; otherwise the first
    reason in this order that `_ssd_chunked` runs them:
      "grad"    grad mode is on and some input needs a gradient (the
                kernel has no backward);
      "dtype"   xh, Bm, Cm not bfloat16, da, dt not float32, or `cdt` not
                bfloat16;
      "dims"    shapes that do not match, or (N, P) not in DIMS;
      "chunk"   a chunk not in CHUNKS or not dividing S;
      "layout"  rows of xh, Bm, Cm not 16-byte aligned and dense;
      "device"  not all on one CUDA device (every CPU tensor)."""
    ins = (xh, Bm, Cm, da, dt)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return "grad"
    if (cdt != torch.bfloat16 or
            any(t.dtype != torch.bfloat16 for t in ins[:3]) or
            da.dtype != torch.float32 or dt.dtype != torch.float32):
        return "dtype"
    if xh.dim() != 4 or Bm.dim() != 3 or da.dim() != 3:
        return "dims"
    B, S, H, P = xh.shape
    if ((Bm.shape[-1], P) not in DIMS or Bm.shape != Cm.shape
            or tuple(Bm.shape[:2]) != (B, S)
            or da.shape != (B, S, H) or dt.shape != (B, S, H)):
        return "dims"
    if chunk not in CHUNKS or S % chunk:
        return "chunk"
    if not (_aligned(xh, range(3)) and _aligned(Bm, range(2))
            and _aligned(Cm, range(2))):
        return "layout"
    if xh.device.type != "cuda" or any(t.device != xh.device
                                       for t in ins[1:]):
        return "device"
    return "kernel"


def _launcher():
    """(ssd_launch, ssd_scratch_floats) of `csrc/ssd.cu`."""
    if not _launch:
        lib = _build.load("ssd")
        fn = lib.ssd_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        size = lib.ssd_scratch_floats
        size.argtypes = [ctypes.c_int] * 5
        size.restype = ctypes.c_int64
        _launch.extend((fn, size))
    return _launch


def ssd_chunked(xh, Bm, Cm, da, dt, chunk: int):
    """The chunked SSD of one block on the card: (y (B,S,H,P) float32,
    final state (B,H,N,P) float32)."""
    global LAUNCHES
    why = route(xh, Bm, Cm, da, dt, chunk, torch.bfloat16)
    if why != "kernel":
        raise ValueError(f"ssd kernel does not take these inputs: {why}")
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    f32 = dict(dtype=torch.float32, device=xh.device)
    y = torch.empty((B, S, H, P), **f32)
    state = torch.empty((B, H, N, P), **f32)
    launch, scratch_floats = _launcher()
    scratch = torch.empty(scratch_floats(B, S, H, N, chunk), **f32)
    strides = (ctypes.c_int64 * 13)(
        *xh.stride()[:3], *Bm.stride()[:2], *Cm.stride()[:2],
        *da.stride(), *dt.stride())
    with torch.cuda.device(xh.device):
        err = launch(
            xh.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), da.data_ptr(),
            dt.data_ptr(), y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
            strides, B, S, H, N, P, chunk,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y, state
