"""Flash attention forward (causal / windowed, GQA) on the card.

`flash_attention(q, k, v)` takes q (B,H,Sq,D) and k/v (B,Hkv,Sk,D) of one
dtype, float16, bfloat16 or float32, at any head dim D from 1 to
MAX_HEAD_DIM, and returns (B,H,Sq,D) in q's dtype, as the Pallas kernel
does.  The inputs may be strided views (the transposed (B,S,H,D)
activations of a model) as long as the last dimension is contiguous and
the strides and start suit the loads of the kernel that runs them (see
`layout_strides`); anything else raises, on the CPU too, and nothing is
copied.  The output has q's memory order (`torch.empty_like(q)`): the
(B,H,S,D) view of a (B,S,H,D) q gets the (B,H,S,D) view of a (B,S,H,D)
output.

On CUDA tensors it launches a hand-written kernel of
`csrc/flash_attention.cu` (on the current stream, without synchronising),
the one `variant(dtype, head_dim)` names, at the narrowest of its
compiled pipeline widths (WIDTHS) that holds D:

  "wgmma"  float16 or bfloat16, D % 8 == 0, 64 <= D <= 256: TMA and
           warpgroup MMA; a D below its width (zamba2's 112, 72, 96 ...)
           runs on TMA's zero fill of the columns past D;
  "mma"    float16 or bfloat16, D % 8 == 0, D < 64: mma.sync;
  "simt"   float32 at any D, and a 16-bit type where no tensor-core route
           applies (D % 8 != 0, or D > 256): float32 FMA.

On CPU tensors it computes the plain version, `ref.flash_attention_ref`.
There is no other route: a CUDA tensor that the kernel cannot take
raises.

LAUNCHES counts the kernel launches, VARIANT_LAUNCHES the launches of each
variant and DTYPE_LAUNCHES those of each (variant, dtype) pair, keyed
"wgmma/float16" and so on, so a run can show that its attention went
through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

MAX_HEAD_DIM = 512    # the simt kernel's shared memory: about 320 D bytes
DTYPES = (torch.float32, torch.bfloat16, torch.float16)  # C launcher codes
VARIANTS = ("simt", "mma", "wgmma")                      # C launcher codes
# the pipeline widths each variant is compiled for; a launch runs D on the
# narrowest that holds it
WIDTHS = {"simt": (32, 64, 128, 256, 512), "mma": (16, 32, 64),
          "wgmma": (64, 128, 256)}

LAUNCHES = 0
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)
DTYPE_LAUNCHES: dict[str, int] = {}
_launch = None


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that runs inputs of `dtype` and `head_dim`."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float16, bfloat16 or "
                        f"float32, got {dtype}")
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {head_dim} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if dtype != torch.float32 and head_dim % 8 == 0 and head_dim <= 256:
        return "wgmma" if head_dim >= 64 else "mma"
    return "simt"


def width(name: str, head_dim: int) -> int:
    """The pipeline width of variant `name` that runs `head_dim`."""
    return next(w for w in WIDTHS[name] if w >= head_dim)


def _launcher():
    global _launch
    if _launch is None:
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> tuple[str, list[int]]:
    """Raises on inputs no variant takes; returns the variant and q's,
    k's and v's strides (see layout_strides)."""
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
    name = variant(q.dtype, D)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1 or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: q, k, v must lie together on "
                         f"the cpu or one cuda device, got {devs}")
    return name, [s for t, n in ((q, "q"), (k, "k"), (v, "v"))
                  for s in layout_strides(t, n, name)]


def layout_strides(t: torch.Tensor, name: str = "tensor",
                   kernel: str = "wgmma") -> list[int]:
    """The batch, head and row element strides of a (B, heads, S, D) view
    that variant `kernel` takes, or ValueError.  Every variant wants the
    last dimension contiguous.  "wgmma" (the TMA) and "mma" (16-byte
    loads) want every other stride a multiple of 16 bytes and the start
    16-byte aligned; "simt" reads element by element and takes any
    positive stride.  A dimension of size 1 has no stride that matters;
    it is given D."""
    D = t.shape[-1]
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name}'s last dimension must be "
                         f"contiguous, got strides {tuple(t.stride())}")
    align = t.element_size() if kernel == "simt" else 16
    out = []
    for size, stride in zip(t.shape[:3], t.stride()[:3]):
        stride = D if size == 1 else stride
        if stride <= 0 or stride * t.element_size() % align:
            raise ValueError(f"flash_attention: {name}'s strides "
                             f"{tuple(t.stride())} are not multiples of "
                             f"{align} bytes ({kernel} kernel)")
        out.append(stride)
    if t.data_ptr() % align:
        raise ValueError(f"flash_attention: {name} does not start on a "
                         f"{align}-byte boundary ({kernel} kernel)")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (B,H,Sq,D) in q's memory order;
    the kernel picks its own tiles."""
    global LAUNCHES
    window = int(window)
    name, strides = _check(q, k, v, window)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    out = torch.empty_like(q)
    if q.device.type == "cpu":
        return out.copy_(ref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window, scale=scale))
    if name != "wgmma" and B * H > 65535:
        raise ValueError(f"flash_attention: B*H = {B * H} > 65535")
    c_strides = (ctypes.c_int64 * 12)(*strides,
                                      *layout_strides(out, "out", name))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), B, H, Hkv, Sq, Sk, D, c_strides,
                          int(bool(causal)), window, scale,
                          DTYPES.index(q.dtype), VARIANTS.index(name),
                          width(name, D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({name}, {q.dtype}) "
                           f"launch failed: CUDA error {err}")
    LAUNCHES += 1
    VARIANT_LAUNCHES[name] += 1
    key = f"{name}/{str(q.dtype).removeprefix('torch.')}"
    DTYPE_LAUNCHES[key] = DTYPE_LAUNCHES.get(key, 0) + 1
    return out
