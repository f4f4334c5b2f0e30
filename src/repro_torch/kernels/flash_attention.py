"""Flash attention forward (causal / windowed, GQA) on the card.

`flash_attention(q, k, v)` takes q (B,H,Sq,D) and k/v (B,Hkv,Sk,D), each
in its own floating type (float32, bfloat16, float16 or one of the five
float8 formats: `DTYPES`), at any head dim D >= 1, any strides and any
B*H, and returns (B,H,Sq,D) in q's dtype, as the Pallas kernel does: each
operand is read as float32, the output is rounded to q's type as the
reference's `astype` rounds (`ref.round_to`).  A window <= 0 is no
window, as the Pallas kernel reads it.  Nothing is copied: each kernel
reads q, k and v through their own strides (the transposed (B,S,H,D)
activations of a model, a strided or misaligned view) and writes the
output through its.  The output has q's
memory order (`torch.empty_like(q)`): the (B,H,S,D) view of a (B,S,H,D)
q gets the (B,H,S,D) view of a (B,S,H,D) output.

On CUDA tensors it launches a hand-written kernel of
`csrc/flash_attention.cu` (on the current stream, without synchronising),
the one `route(q, k, v)` names (`variant(dtype, D, tma)` when q, k and v
share one type, "simt" otherwise), at the width `width(name, D)` picks
from its compiled ones (WIDTHS):

  "wgmma"  float16 or bfloat16, D % 8 == 0, D <= 256, on layouts the TMA
           takes (`tma_layout`): TMA, mbarrier ring and warpgroup MMA at
           width 64, 128 or 256; a D below its width runs on TMA's zero
           fill of the columns past D.  Bound by the tensor cores' rate
           (and, below D = 64, by the exponentials' rate);
  "mma"    float16 or bfloat16 at D <= 256 otherwise (D % 8 != 0, or a
           layout the TMA cannot take): mma.sync m16n8k16 fed by ldmatrix
           from a cp.async ring (16, 8 or 4 bytes a copy, or element by
           element: `copy_elems`), width 32 to 256;
  "simt"   float32 at any D, float16 or bfloat16 at D > 256, and every
           float8 input or mix of types at any D: float32 FMA, no TF32; a
           block computes 32, 64 or 128 output columns and a grid
           dimension of column chunks covers any D.  A mix or a float8
           input runs its own kernel of the file, which reads and writes
           each tensor in its own type (`DTYPES`; float8 decoded
           through `ref.decode_table`, the 256 values of its format).

On CPU tensors it computes the plain version, `ref.flash_attention_ref`.
There is no other route: on a CUDA tensor the kernel runs or the call
raises.

LAUNCHES counts the kernel launches, VARIANT_LAUNCHES the launches of each
variant and DTYPE_LAUNCHES those of each (variant, dtype) pair, keyed
"wgmma/float16" and so on, or by the four types of q, k, v and the output
where they differ ("simt/bfloat16,float8_e4m3fn,float8_e4m3fn,bfloat16"),
so a run can show that its attention went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

# the launcher's type codes: the three of the tensor-core and float32
# kernels, then the float8 formats
DTYPES = (torch.float32, torch.bfloat16, torch.float16,
          torch.float8_e4m3fn, torch.float8_e5m2, torch.float8_e4m3fnuz,
          torch.float8_e5m2fnuz, torch.float8_e8m0fnu)
VARIANTS = ("simt", "mma", "wgmma")                      # C launcher codes
# the widths each variant is compiled for: the narrowest that holds D runs
# it (wgmma and mma: the pipeline's columns; simt: the output columns a
# block computes, the widest when D is wider)
WIDTHS = {"simt": (32, 64, 128),
          "mma": (32, 64, 96, 112, 128, 160, 192, 256),
          "wgmma": (64, 128, 256)}
TC_MAX_HEAD_DIM = 256   # widest D of the tensor-core variants

LAUNCHES = 0
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)
DTYPE_LAUNCHES: dict[str, int] = {}
_launch = None


def variant(dtype: torch.dtype, head_dim: int, tma: bool = True) -> str:
    """The kernel that runs inputs of `dtype` and `head_dim`; `tma` says
    whether q, k, v and the output all lie as the TMA takes them."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32, bfloat16, float16 "
                        f"or a float8 type, got {dtype}")
    if head_dim < 1:
        raise ValueError(f"flash_attention: head_dim {head_dim} < 1")
    if dtype not in DTYPES[1:3] or head_dim > TC_MAX_HEAD_DIM:
        return "simt"
    return "wgmma" if tma and head_dim % 8 == 0 else "mma"


def width(name: str, head_dim: int) -> int:
    """The compiled width of variant `name` that runs `head_dim`: the
    narrowest that holds it (simt: the widest when none does)."""
    return next((w for w in WIDTHS[name] if w >= head_dim),
                WIDTHS[name][-1])


def layout_strides(t: torch.Tensor) -> list[int]:
    """The batch, head, row and column element strides of a (B, heads, S,
    D) view, a dimension of size 1 given 0 (only index 0 reaches it)."""
    return [0 if n == 1 else s for n, s in zip(t.shape, t.stride())]


def tma_layout(t: torch.Tensor) -> bool:
    """Whether the TMA (and the wgmma kernel's 16-byte stores) take `t`:
    the column stride 1, a 16-byte aligned start, every other stride of a
    dimension longer than 1 a positive multiple of 16 bytes, and rows that
    do not overlap."""
    sb, sh, ss, sd = layout_strides(t)
    B, heads, S, D = t.shape
    item = t.element_size()
    return (sd == 1 and t.data_ptr() % 16 == 0 and (S == 1 or ss >= D)
            and all(n == 1 or (s > 0 and s * item % 16 == 0)
                    for n, s in ((B, sb), (heads, sh), (S, ss))))


def copy_elems(t: torch.Tensor) -> int:
    """Elements one copy of the mma and simt kernels moves for `t`: the
    most, 16, 8 or 4 bytes' worth (cp.async's sizes), that divides D with
    the column stride 1 and the start and the other strides multiples of
    the copy's bytes; 1 (element by element, any strides) otherwise."""
    sb, sh, ss, sd = layout_strides(t)
    D, item = t.shape[-1], t.element_size()
    n = 16 // item
    while n > 1 and n * item >= 4:
        size = n * item
        if (sd == 1 and D % n == 0 and t.data_ptr() % size == 0
                and all(s * item % size == 0 for s in (sb, sh, ss))):
            return n
        n //= 2
    return 1


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          out: torch.Tensor | None = None) -> str:
    """The variant that runs these inputs and output (by default
    `torch.empty_like(q)`, the wrapper's): by dtype, D and layout; "simt"
    for q, k and v of more than one type."""
    out = torch.empty_like(q) if out is None else out
    name = variant(q.dtype, q.shape[-1],
                   all(tma_layout(t) for t in (q, k, v, out)))
    for t in (k, v):
        variant(t.dtype, 1)               # raises for a type no kernel reads
    return name if k.dtype == v.dtype == q.dtype else "simt"


def dtype_key(name: str, *dtypes: torch.dtype) -> str:
    """The DTYPE_LAUNCHES key of a launch of variant `name` on tensors of
    these types: one type name when they all share it, else each."""
    names = [str(d).removeprefix("torch.") for d in dtypes]
    return f"{name}/{names[0] if len(set(names)) == 1 else ','.join(names)}"


def _launcher():
    global _launch
    if _launch is None:
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raises on inputs no variant takes: types that are not in DTYPES
    (float64, integers), shapes that do not match, D < 1, tensors apart."""
    for t in (q, k, v):
        if t.dtype not in DTYPES:
            raise TypeError(f"flash_attention takes float32, bfloat16, "
                            f"float16 or float8 q, k, v, got {q.dtype}, "
                            f"{k.dtype}, {v.dtype}")
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
    devs = {q.device, k.device, v.device}
    if len(devs) != 1 or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: q, k, v must lie together on "
                         f"the cpu or one cuda device, got {devs}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (B,H,Sq,D) in q's memory order;
    the kernel picks its own tiles."""
    global LAUNCHES
    window = max(int(window), 0)          # <= 0: no window, as in Pallas
    _check(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    out = torch.empty_like(q)
    if q.device.type == "cpu":
        return out.copy_(ref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window, scale=scale))
    name = route(q, k, v, out)
    tensors = (q, k, v, out)
    c_strides = (ctypes.c_int64 * 16)(*[s for t in tensors
                                        for s in layout_strides(t)])
    c_vecs = (ctypes.c_int * 4)(*[copy_elems(t) for t in tensors])
    c_types = (ctypes.c_int * 4)(*[DTYPES.index(t.dtype) for t in tensors])
    with torch.cuda.device(q.device):
        # each float8 input's 256 values, which the kernel decodes through
        c_tables = (ctypes.c_void_p * 3)(*[
            ref.decode_table(t.dtype, q.device).data_ptr()
            if t.element_size() == 1 else None for t in (q, k, v)])
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), B, H, Hkv, Sq, Sk, D, c_strides,
                          c_vecs, int(bool(causal)), window, scale, c_types,
                          c_tables, VARIANTS.index(name), width(name, D),
                          stream)
    key = dtype_key(name, *(t.dtype for t in tensors))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({key}) launch failed: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    VARIANT_LAUNCHES[name] += 1
    DTYPE_LAUNCHES[key] = DTYPE_LAUNCHES.get(key, 0) + 1
    return out
