"""Flash attention forward (causal / windowed, GQA) on the card.

`flash_attention(q, k, v)` takes q (B,H,Sq,D) and k/v (B,Hkv,Sk,D) and
returns (B,H,Sq,D) in q's dtype.  The inputs may be strided views (the
transposed (B,S,H,D) activations of a model) as long as the last dimension
is contiguous and every stride is a multiple of 16 bytes from a 16-byte
aligned start, which is what the card's tensor memory accelerator (TMA)
takes; anything else raises, on the CPU too, and nothing is copied.  The
output has q's memory order (`torch.empty_like(q)`): the (B,H,S,D) view of
a (B,S,H,D) q gets the (B,H,S,D) view of a (B,S,H,D) output.

On CUDA tensors it launches a hand-written kernel of
`csrc/flash_attention.cu` (on the current stream, without synchronising),
the one `variant(dtype, head_dim)` names: "wgmma" (bfloat16, D >= 64: TMA
and warpgroup MMA; D=112 runs the D=128 pipeline on TMA's zero fill),
"mma" (bfloat16, D < 64: mma.sync) or "simt" (float32 FMA).  On CPU tensors it computes the plain version,
`ref.flash_attention_ref`.  There is no other route: a CUDA tensor that
the kernel cannot take raises.

LAUNCHES counts the kernel launches, VARIANT_LAUNCHES the launches of each
variant, so a run can show that its attention went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

HEAD_DIMS = (16, 32, 64, 112, 128, 256)
VARIANTS = ("simt", "mma", "wgmma")      # their codes in the C launcher

LAUNCHES = 0
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)
_launch = None


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that runs inputs of `dtype` and `head_dim`."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {head_dim} not in "
                         f"{HEAD_DIMS}")
    if dtype == torch.float32:
        return "simt"
    if dtype == torch.bfloat16:
        return "wgmma" if head_dim >= 64 else "mma"
    raise TypeError(f"flash_attention takes float32 or bfloat16, got {dtype}")


def _launcher():
    global _launch
    if _launch is None:
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> list[int]:
    """Raises on inputs no variant takes; returns q's, k's and v's
    strides (see layout_strides)."""
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (B,H,Sq,D) and k, v "
                         f"(B,Hkv,Sk,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if Bk != B or Dk != D or Hkv < 1 or H % Hkv or Sq < 1 or Sk < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    variant(q.dtype, D)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1 or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: q, k, v must lie together on "
                         f"the cpu or one cuda device, got {devs}")
    return [s for t, name in ((q, "q"), (k, "k"), (v, "v"))
            for s in layout_strides(t, name)]


def layout_strides(t: torch.Tensor, name: str = "tensor") -> list[int]:
    """The batch, head and row element strides of a (B, heads, S, D) view
    the kernels take, or ValueError: the last dimension contiguous, every
    other stride a multiple of 16 bytes and the start 16-byte aligned (the
    TMA's rules).  A dimension of size 1 has no stride that matters; it is
    given D."""
    D = t.shape[-1]
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name}'s last dimension must be "
                         f"contiguous, got strides {tuple(t.stride())}")
    out = []
    for size, stride in zip(t.shape[:3], t.stride()[:3]):
        stride = D if size == 1 else stride
        if stride <= 0 or stride * t.element_size() % 16:
            raise ValueError(f"flash_attention: {name}'s strides "
                             f"{tuple(t.stride())} are not multiples of 16 "
                             f"bytes")
        out.append(stride)
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} does not start on a "
                         f"16-byte boundary")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (B,H,Sq,D) in q's memory order;
    the kernel picks its own tiles."""
    global LAUNCHES
    window = int(window)
    strides = _check(q, k, v, window)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    out = torch.empty_like(q)
    if q.device.type == "cpu":
        return out.copy_(ref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window, scale=scale))
    name = variant(q.dtype, D)
    if name != "wgmma" and B * H > 65535:
        raise ValueError(f"flash_attention: B*H = {B * H} > 65535")
    c_strides = (ctypes.c_int64 * 12)(*strides, *layout_strides(out, "out"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), B, H, Hkv, Sq, Sk, D, c_strides,
                          int(bool(causal)), window, scale,
                          VARIANTS.index(name), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({name}) launch failed: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    VARIANT_LAUNCHES[name] += 1
    return out
