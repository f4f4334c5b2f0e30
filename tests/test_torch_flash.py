"""The port's flash attention (K3) against the JAX reference.

The same numpy inputs, made from a seed, go through the Pallas kernel of
`repro.kernels.flash_attention` (in interpret mode, as the reference's own
tests run it) and through the port: its plain version
`ref.flash_attention_ref` and its entry point `ops.flash_attention` on CPU
tensors.  Tolerances are the reference's own (`tests/test_kernels.py`):
2e-5 in float32, 2e-2 in bfloat16 (one rounding of the output).  The
reference states none for float16; 5e-3 here: both sides compute in
float32 from the same float16 inputs and round the output once, so they
part by at most one float16 ulp of an output (2^-9 = 2e-3 for outputs
up to 4), and the card's kernel adds its rounding of P to float16 (2^-11
a weight, times |v| of about 4 at most), so 5e-3 holds the kernel too
with room for neither a dropped tile nor a bf16/f16 mix-up.  The CUDA
kernel itself is held against the plain version on the card by the
`card` tests at the end: every variant over a grid of shapes, windows,
layouts and head dims, each float8 format and mix of types, and its
rounding and decoding of every pattern a type has.  Its limits (TOL and
the card's brackets) live in `_card.py`, which `chip_smoke.py`'s
timings hold the kernel to as well.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from _card import (TOL, U_C, card, close,  # noqa: E402,F401
                   close_on_route, scaled_ok)

try:                                     # the card test needs no JAX
    import jax.numpy as jnp
    from repro.kernels import flash_attention as jfa
except ImportError:                      # pragma: no cover
    jnp = jfa = None


@pytest.fixture
def pallas():
    if jfa is None:
        pytest.skip("needs jax for the reference kernel")
    return jfa


def _inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q, dtype=np.float32),
            rng.standard_normal(shape_kv, dtype=np.float32),
            rng.standard_normal(shape_kv, dtype=np.float32))


def _reference(pallas, arrays, dtype, **kw):
    jd = getattr(jnp, dtype)
    q, k, v = (jnp.asarray(a).astype(jd) for a in arrays)
    out = pallas.flash_attention(q, k, v, interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(fn, arrays, dtype, **kw):
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(td) for a in arrays)
    out = fn(q, k, v, **kw)
    assert out.dtype == td and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("B,H,Hkv,S,D", [
    (1, 1, 1, 128, 64),       # MHA
    (2, 4, 2, 128, 64),       # GQA 2:1
    (1, 8, 1, 256, 64),       # MQA
    (1, 4, 4, 64, 128),       # head_dim 128
    (2, 2, 2, 192, 32),       # non-pow2 seq (block 64)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_shapes_dtypes(pallas, B, H, Hkv, S, D, dtype):
    arrays = _inputs((B, H, S, D), (B, Hkv, S, D), B * H * S + D)
    want = _reference(pallas, arrays, dtype, causal=True, block_q=64,
                      block_k=64)
    plain = _port(ref.flash_attention_ref, arrays, dtype, causal=True,
                  block_k=64)
    entry = _port(ops.flash_attention, arrays, dtype, causal=True,
                  block_q=64, block_k=64)
    assert np.abs(plain - want).max() < TOL[dtype]
    assert np.abs(entry - want).max() < TOL[dtype]


@pytest.mark.parametrize("window", [32, 64, 100])
def test_flash_attention_sliding_window(pallas, window):
    arrays = _inputs((1, 2, 256, 64), (1, 2, 256, 64), window)
    want = _reference(pallas, arrays, "float32", causal=True, window=window,
                      block_q=64, block_k=64)
    got = _port(ops.flash_attention, arrays, "float32", causal=True,
                window=window, block_q=64, block_k=64)
    assert np.abs(got - want).max() < 2e-5


def test_flash_attention_noncausal(pallas):
    arrays = _inputs((1, 2, 128, 64), (1, 2, 128, 64), 5)
    want = _reference(pallas, arrays, "float32", causal=False, block_q=64,
                      block_k=64)
    got = _port(ops.flash_attention, arrays, "float32", causal=False,
                block_q=64, block_k=64)
    assert np.abs(got - want).max() < 2e-5


@pytest.mark.parametrize("window", [16, 100])
def test_flash_attention_noncausal_window_follows_the_kernel(pallas, window):
    """The Pallas kernel applies the window without causal too; its oracle
    does not (ROADMAP R2).  The port follows the kernel."""
    arrays = _inputs((2, 4, 128, 32), (2, 2, 128, 32), window)
    want = _reference(pallas, arrays, "float32", causal=False, window=window,
                      block_q=64, block_k=64)
    got = _port(ops.flash_attention, arrays, "float32", causal=False,
                window=window, block_q=64, block_k=64)
    assert np.abs(got - want).max() < 2e-5


@pytest.mark.parametrize("Sq,Sk,window", [(64, 256, 0), (128, 256, 100),
                                          (64, 192, 32)])
def test_flash_attention_shorter_query_aligns_bottom_right(pallas, Sq, Sk,
                                                           window):
    arrays = _inputs((1, 4, Sq, 64), (1, 2, Sk, 64), Sq + Sk)
    want = _reference(pallas, arrays, "float32", causal=True, window=window,
                      block_q=64, block_k=64)
    got = _port(ops.flash_attention, arrays, "float32", causal=True,
                window=window, block_q=64, block_k=64)
    assert np.abs(got - want).max() < 2e-5


def test_flash_attention_block_shape_independence():
    """Output must not depend on the key tiling of the plain version."""
    arrays = _inputs((1, 2, 256, 64), (1, 1, 256, 64), 0)
    outs = [_port(ref.flash_attention_ref, arrays, "float32", block_k=bk)
            for bk in (64, 128, 32, 256)]
    for o in outs[1:]:
        assert np.abs(o - outs[0]).max() < 1e-5


def test_flash_attention_row_with_no_key_is_zero():
    """Sq > Sk, causal: the first Sq - Sk rows keep no key and give 0."""
    q, k, v = (torch.from_numpy(a) for a in
               _inputs((1, 2, 96, 32), (1, 2, 64, 32), 9))
    out = fa.flash_attention(q, k, v, causal=True)
    assert torch.isfinite(out).all()
    assert out[:, :, :32].abs().max() == 0
    assert out[:, :, 32:].abs().max() > 0


def test_ops_keeps_the_reference_block_contract():
    q, k, v = (torch.from_numpy(a) for a in
               _inputs((1, 2, 100, 32), (1, 2, 100, 32), 1))
    with pytest.raises(ValueError, match="divide"):
        ops.flash_attention(q, k, v, block_q=64, block_k=64)
    # clamped to the sequence, the blocks divide it
    assert ops.flash_attention(q, k, v).shape == q.shape


def test_wrapper_checks_and_routes_only_cpu_tensors_to_plain(monkeypatch):
    q = torch.zeros((1, 4, 8, 32))
    kv = torch.zeros((1, 2, 8, 32))
    # float16 and any head dim run, as in the Pallas kernel
    assert fa.flash_attention(q.half(), kv.half(), kv.half()).dtype == \
        torch.float16
    for D in (48, 520):
        assert fa.flash_attention(torch.zeros((1, 4, 8, D)),
                                  torch.zeros((1, 2, 8, D)),
                                  torch.zeros((1, 2, 8, D))).shape[-1] == D
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), kv.double(), kv.double())
    # mixed types compute, each operand read in its own type, the output
    # in q's (as the Pallas kernel casts each to float32)
    assert fa.flash_attention(q, kv.bfloat16(), kv).dtype == torch.float32
    assert fa.flash_attention(q.half(), kv.half(),
                              kv.bfloat16()).dtype == torch.float16
    for other in (torch.float64, torch.int32):
        with pytest.raises(TypeError):
            fa.flash_attention(q, kv, kv.to(other))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(torch.zeros((1, 4, 8, 0)),
                           torch.zeros((1, 2, 8, 0)),
                           torch.zeros((1, 2, 8, 0)))
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros((1, 3, 8, 32)),
                           torch.zeros((1, 3, 8, 32)))
    # a negative window is no window, as the Pallas kernel reads it
    assert torch.equal(fa.flash_attention(q, kv, kv, window=-1),
                       fa.flash_attention(q, kv, kv, window=0))

    def plain_must_not_run(*a, **kw):
        raise AssertionError("plain version reached")
    monkeypatch.setattr(ref, "flash_attention_ref", plain_must_not_run)
    meta = [t.to("meta") for t in (q, kv, kv)]
    with pytest.raises(ValueError):
        fa.flash_attention(*meta)
    launches = fa.LAUNCHES
    with pytest.raises(AssertionError, match="plain version reached"):
        fa.flash_attention(q, kv, kv)
    assert fa.LAUNCHES == launches        # the CPU route launches nothing


def _bshd_views(arrays, dtype):
    """The (B,H,S,D) views of (B,S,H,D) copies of `arrays`, as the model's
    attention passes them: not contiguous, last dimension dense."""
    td = getattr(torch, dtype)
    return [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
            .to(td).transpose(1, 2) for a in arrays]


@pytest.mark.parametrize("B,H,Hkv,S,D,window", [
    (2, 4, 2, 128, 64, 0),
    (1, 8, 2, 192, 32, 100),
    (2, 4, 4, 64, 128, 0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_strided_views_match_pallas(pallas, dtype, B, H, Hkv,
                                                    S, D, window):
    """(B,S,H,D)-transposed inputs give a (B,S,H,D) output, no copies."""
    arrays = _inputs((B, H, S, D), (B, Hkv, S, D), 7 * S + D)
    want = _reference(pallas, arrays, dtype, causal=True, window=window,
                      block_q=64, block_k=64)
    q, k, v = _bshd_views(arrays, dtype)
    assert not q.is_contiguous()
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              block_q=64, block_k=64)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.transpose(1, 2).is_contiguous()
    assert np.abs(out.float().numpy() - want).max() < TOL[dtype]


def _designed(dtype, D):
    """The variant rule, written out, for layouts the TMA takes: tensor
    cores for 16-bit types up to D = 256 (wgmma at D % 8 == 0, mma
    otherwise), float32 FMA for float32 and above 256."""
    if dtype == "float32" or D > 256:
        return "simt"
    return "wgmma" if D % 8 == 0 else "mma"


@pytest.mark.parametrize("D", [16, 32, 64, 112, 128, 256, 1, 8, 63, 72,
                               264, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_variant_is_the_designed_kernel(dtype, D):
    name = fa.variant(getattr(torch, dtype), D)
    assert name == _designed(dtype, D) and name in fa.VARIANTS
    w = fa.width(name, D)
    narrower = [x for x in fa.WIDTHS[name] if x < w]
    assert w in fa.WIDTHS[name] and all(x < D for x in narrower)
    if name == "simt":        # D beyond the widest: column chunks
        assert D <= w or w == fa.WIDTHS["simt"][-1]
    else:
        assert D <= w
    if name == "wgmma":       # the launcher's Q K^T step counts: 1-4 at
        assert w == 64 or 2 * D > w   # width 64, (w/2, w] above


@pytest.mark.parametrize("dtype,D,want", [
    ("float16", 128, "wgmma"), ("bfloat16", 48, "wgmma"),
    ("float32", 8, "simt"), ("bfloat16", 512, "simt"),
    ("bfloat16", 96, "wgmma"), ("float32", 120, "simt"),
    ("float16", 520, "simt"), ("float32", 1024, "simt"),
])
def test_variant_takes_what_the_reference_computes(dtype, D, want):
    """Inputs the Pallas kernel computes and the port once refused (float16,
    D outside 16/32/64/112/128/256, D above 512): each has a kernel now."""
    assert fa.variant(getattr(torch, dtype), D) == want


@pytest.mark.parametrize("dtype,D,error", [
    ("float64", 64, TypeError), ("int32", 128, TypeError),
    ("bfloat16", 0, ValueError),
])
def test_variant_raises_on_other_inputs(dtype, D, error):
    with pytest.raises(error):
        fa.variant(getattr(torch, dtype), D)


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_head_dim_112_matches_pallas(pallas, dtype, window):
    """zamba2-7b's head_dim: the Pallas kernel (interpret mode) takes any
    D; the port's plain version and its entry point on CPU tensors (the
    (B,H,S,D) views of (B,S,H,D) tensors, as zamba2's shared block passes
    them) agree with it at D=112."""
    arrays = _inputs((2, 4, 128, 112), (2, 4, 128, 112), 112 + window)
    want = _reference(pallas, arrays, dtype, causal=True, window=window,
                      block_q=64, block_k=64)
    plain = _port(ref.flash_attention_ref, arrays, dtype, causal=True,
                  window=window)
    assert np.abs(plain - want).max() < TOL[dtype]
    q, k, v = _bshd_views(arrays, dtype)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    assert fa.variant(q.dtype, 112) == ("simt" if dtype == "float32"
                                        else "wgmma")
    assert out.transpose(1, 2).is_contiguous()
    assert np.abs(out.float().numpy() - want).max() < TOL[dtype]


# the head dims the card tests hold beyond the models' 16-256
# (NEW_HEAD_DIMS below: every branch of `variant`, wgmma at width 64 and
# on mostly empty last TMA boxes, mma, simt for 16-bit types), each with
# its (B, H, Hkv, S, window) here: GQA everywhere, a window on some (S a
# multiple of 64, as Pallas's blocks must divide it)
_NEW_D_SHAPES = {8: (2, 4, 2, 128, 0), 40: (1, 4, 2, 128, 32),
                 48: (1, 4, 1, 128, 0), 80: (1, 4, 2, 128, 0),
                 96: (2, 2, 1, 128, 50), 100: (1, 4, 2, 128, 0),
                 120: (1, 2, 2, 128, 0), 136: (1, 4, 2, 128, 64),
                 160: (1, 2, 1, 128, 0), 192: (1, 4, 2, 64, 0),
                 200: (1, 2, 1, 128, 100), 320: (1, 2, 1, 64, 0),
                 512: (1, 2, 1, 64, 0)}


@pytest.mark.parametrize("D", [520, 768, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_head_dims_above_512_match_pallas(pallas, dtype, D):
    """D above 512, which the card's simt kernel runs in column chunks of
    128 (no cap on D): the entry point on CPU tensors, q as the (B,H,S,D)
    view of a (B,S,H,D) tensor, against the Pallas kernel in interpret
    mode on the same numpy inputs."""
    arrays = _inputs((1, 4, 64, D), (1, 2, 64, D), D)
    want = _reference(pallas, arrays, dtype, causal=True, block_q=64,
                      block_k=64)
    q, k, v = _bshd_views(arrays, dtype)
    assert fa.route(q, k, v) == "simt"
    out = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    assert out.dtype == q.dtype and out.transpose(1, 2).is_contiguous()
    assert np.abs(out.float().numpy() - want).max() < TOL[dtype]


@pytest.mark.parametrize("D", sorted(_NEW_D_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_new_head_dims_match_pallas(pallas, dtype, D):
    """Every head dim of phase 7 beyond the models' own, in the three
    dtypes: the plain version and the entry point on CPU tensors (q as
    the (B,H,S,D) view of a (B,S,H,D) tensor) against the Pallas kernel
    in interpret mode, on the same numpy inputs."""
    B, H, Hkv, S, window = _NEW_D_SHAPES[D]
    arrays = _inputs((B, H, S, D), (B, Hkv, S, D), 3 * D + H)
    want = _reference(pallas, arrays, dtype, causal=True, window=window,
                      block_q=64, block_k=64)
    plain = _port(ref.flash_attention_ref, arrays, dtype, causal=True,
                  window=window, block_k=64)
    assert np.abs(plain - want).max() < TOL[dtype]
    q, k, v = _bshd_views(arrays, dtype)
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              block_q=64, block_k=64)
    assert out.dtype == q.dtype and out.transpose(1, 2).is_contiguous()
    assert np.abs(out.float().numpy() - want).max() < TOL[dtype]


def _strided(kind):
    """A q of shape (1, 4, 64, D) (D = 32, or 20 for the last) laid out as
    `kind`, zeros."""
    if kind == "last_dim_strided":
        return torch.zeros((1, 4, 64, 64))[..., ::2]
    if kind == "row_stride_72_bytes":          # bf16 rows 36 apart
        return torch.zeros((1, 4, 64, 36), dtype=torch.bfloat16)[..., :32]
    if kind == "start_off_16_bytes":           # bf16, 2 bytes past one
        return torch.zeros(4 * 64 * 32 + 1, dtype=torch.bfloat16)[1:].view(
            1, 4, 64, 32)
    if kind == "row_stride_80_bytes":          # bf16 rows 40 apart
        return torch.zeros((1, 4, 64, 40), dtype=torch.bfloat16)[..., :32]
    if kind == "bshd_view":
        return torch.zeros((1, 64, 4, 32)).transpose(1, 2)
    if kind == "simt_start_off_4_bytes":       # f32, one element past
        return torch.zeros(4 * 64 * 32 + 1)[1:].view(1, 4, 64, 32)
    if kind == "simt_row_stride_132_bytes":    # f32 rows 33 apart
        return torch.zeros((1, 4, 64, 33))[..., :32]
    if kind == "simt_last_dim_strided":        # f16 D=20, column stride 2
        return torch.zeros((1, 4, 64, 40), dtype=torch.float16)[..., ::2]
    raise AssertionError(kind)


@pytest.mark.parametrize("kind,kernel", [
    ("last_dim_strided", "simt"), ("row_stride_72_bytes", "mma"),
    ("start_off_16_bytes", "mma"), ("row_stride_80_bytes", "wgmma"),
    ("bshd_view", "simt"), ("simt_start_off_4_bytes", "simt"),
    ("simt_row_stride_132_bytes", "simt"), ("simt_last_dim_strided", "mma"),
])
def test_wrapper_computes_layouts_the_tma_cannot_take(pallas, kind, kernel):
    """Every layout computes, in place.  The card's TMA (wgmma) takes a
    dense last dimension, strides of 16-byte multiples and a 16-byte
    aligned start; the mma (16-bit) and simt (float32) kernels read any
    strides, 16, 8 or 4 bytes a copy where the layout allows and element
    by element where not.  The route the card takes is shown here, and
    the CPU result equals the Pallas kernel's on the same logical
    values."""
    q = _strided(kind)
    D, dname = q.shape[-1], str(q.dtype).removeprefix("torch.")
    arrays = _inputs((1, 4, 64, D), (1, 2, 64, D), 64 + D)
    q.copy_(torch.from_numpy(arrays[0]).to(q.dtype))
    k, v = (torch.from_numpy(a).to(q.dtype) for a in arrays[1:])
    assert fa.route(q, k, v) == kernel
    assert fa.layout_strides(q) == [0, *q.stride()[1:]]
    assert fa.tma_layout(q) == (kind in ("row_stride_80_bytes",
                                         "bshd_view"))
    want = _reference(pallas, [q.float().numpy(), *arrays[1:]], dname,
                      causal=True, block_q=64, block_k=64)
    got = fa.flash_attention(q, k, v).float().numpy()
    assert np.abs(got - want).max() < TOL[dname]


def test_size_one_dims_take_any_stride():
    q = torch.randn((1, 4, 1, 32)).as_strided((1, 4, 1, 32), (3, 32, 5, 1))
    kv = torch.randn((1, 2, 8, 32))
    assert fa.layout_strides(q) == [0, 32, 0, 1]
    assert fa.tma_layout(q)
    assert fa.flash_attention(q, kv, kv).shape == q.shape


@pytest.mark.parametrize("dtype,D,layout,kernel,elems", [
    ("bfloat16", 48, "contiguous", "wgmma", 8),
    ("bfloat16", 100, "contiguous", "mma", 4),
    ("bfloat16", 320, "contiguous", "simt", 8),
    ("bfloat16", 128, "row_72_bytes", "mma", 4),
    ("float16", 128, "bshd", "wgmma", 8),
    ("float16", 8, "contiguous", "wgmma", 8),
    ("bfloat16", 128, "start_off_2_bytes", "mma", 1),
    ("bfloat16", 64, "last_dim_strided", "mma", 1),
    ("float16", 256, "contiguous", "wgmma", 8),
    ("bfloat16", 264, "contiguous", "simt", 8),
    ("float32", 64, "contiguous", "simt", 4),
    ("float32", 100, "start_off_4_bytes", "simt", 1),
])
def test_route_follows_dtype_head_dim_and_layout(dtype, D, layout, kernel,
                                                 elems):
    """The rule the card follows, on CPU tensors: the variant by dtype, D
    and layout (the 72-byte rows are an overlapping view, read only), and
    the elements one copy of mma and simt moves."""
    td = getattr(torch, dtype)
    n = 2 * 4 * 64 * D
    if layout == "contiguous":
        q = torch.zeros((2, 4, 64, D), dtype=td)
    elif layout == "bshd":
        q = torch.zeros((2, 64, 4, D), dtype=td).transpose(1, 2)
    elif layout == "row_72_bytes":             # rows 36 elements apart
        q = torch.zeros(n, dtype=td).as_strided((2, 4, 64, D),
                                                (4 * 64 * 36, 64 * 36, 36, 1))
    elif layout.startswith("start_off"):
        q = torch.zeros(n + 1, dtype=td)[1:].view(2, 4, 64, D)
    else:                                      # last_dim_strided
        q = torch.zeros((2, 4, 64, 2 * D), dtype=td)[..., ::2]
    kv = torch.zeros((2, 2, 64, D), dtype=td)
    assert fa.route(q, kv, kv) == kernel
    assert fa.copy_elems(q) == elems
    assert fa.tma_layout(q) == (layout in ("contiguous", "bshd")
                                and D * q.element_size() % 16 == 0)


@pytest.mark.parametrize("kind,strides", [
    ("contiguous", (8192, 2048, 32, 1)),
    ("bshd_view", (8192, 32, 128, 1)),
    ("row_stride_80_bytes", (8192, 2048, 32, 1)),   # not dense: contiguous
])
def test_output_takes_q_memory_order(kind, strides):
    """The output is `empty_like(q)`: a dense q's strides, else
    contiguous; the model's (B,S,H,D) views get a (B,S,H,D) output."""
    q = (torch.zeros((1, 4, 64, 32)) if kind == "contiguous"
         else _strided(kind))
    q.copy_(torch.randn(q.shape).to(q.dtype))
    kv = torch.randn((1, 2, 64, 32)).to(q.dtype)
    out = fa.flash_attention(q, kv, kv)
    assert out.stride() == strides and out.dtype == q.dtype
    want = fa.flash_attention(q.contiguous(), kv, kv)
    assert (out.float() - want.float()).abs().max() == 0


def test_qwen3_flash_forward_passes_views_and_equals_the_reference(
        pallas, monkeypatch):
    """qwen3's smoke config on attn_impl="flash": each layer's flash call
    gets the (B,S,H,D) activations' transposed views and returns a
    (B,S,H,D) output (no copy on either side), and the forward equals
    the JAX reference's flash forward in f32."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models import layers as JL
    from repro.models import registry as JR
    from repro.models.config import RunConfig
    from repro_torch.configs import get_smoke_config as port_smoke
    from repro_torch.models import config as port_config
    from repro_torch.models import convert
    from repro_torch.models import registry as TR

    cfg = get_smoke_config("qwen3-4b")
    jp = JL.tree_init(JR.param_defs(cfg), jax.random.PRNGKey(3))
    tp = convert.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(seq_len=64, global_batch=2, kind="prefill", attn_impl="flash",
              compute_dtype="float32", remat="none")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 64),
                                             dtype=np.int32)
    x, *_ = JR.forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                       RunConfig(**kw))
    seen = []
    real = fa.flash_attention

    def spy(q, k, v, **kws):
        out = real(q, k, v, **kws)
        seen.append((q.is_contiguous(), k.is_contiguous(),
                     out.transpose(1, 2).is_contiguous()))
        return out
    monkeypatch.setattr(fa, "flash_attention", spy)
    tx, *_ = TR.forward(port_smoke("qwen3-4b"), tp,
                        {"tokens": torch.from_numpy(toks)},
                        port_config.RunConfig(**kw))
    assert seen == [(False, False, True)] * cfg.n_layers
    assert np.abs(tx.numpy() - np.asarray(x)).max() < 1e-5


# ------------------------------------ float8, mixed types, negative windows
#
# The Pallas kernel casts each operand to float32 and rounds the output to
# q's type, so it computes any floating q, k, v: the five float8 formats
# that JAX and torch both define, and any mix.  Inputs are made in numpy
# from a seed, rounded to their type by `ref.round_to` (held to JAX's
# `astype` by test_round_to_matches_the_reference_astype) and handed to
# both packages as the same bytes.  Tolerance: TOL for a float32 or 16-bit
# output; a float8 output is equal or one rounding of its type apart,
# element by element (both sides compute in float32 in another order, so
# an output near the midpoint of two float8 values may round to either).

FLOAT8 = ["float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
          "float8_e5m2fnuz", "float8_e8m0fnu"]


def _rule(names, D, tma):
    """The route the card takes for q, k, v of types `names`, stated here
    apart from the wrapper: the compute type C of the tensor cores is
    float16 where some operand is float16 and each other float16 or a
    float8 format but e8m0fnu, bfloat16 where none is float16 or float32,
    tf32 where some is float16 beside bfloat16 or e8m0fnu and none is
    float32, none where some is float32; with a 16-bit C and D <= 256,
    wgmma where D % 8 == 0 and every tensor lies as the TMA takes it
    (`tma`), else mma; with tf32, wgmma_tf32 where D % 8 == 0, D <= 128
    and the TMA takes every tensor; simt otherwise."""
    if "float32" in names:
        c = None
    elif "float16" in names:
        c = "tf32" if {"bfloat16", "float8_e8m0fnu"} & set(names) \
            else "float16"
    else:
        c = "bfloat16"
    if c == "tf32":
        return "wgmma_tf32" if tma and D % 8 == 0 and D <= 128 else "simt"
    if c is None or D > 256:
        return "simt"
    return "wgmma" if tma and D % 8 == 0 else "mma"


def _typed(a, dtype):
    """numpy float32 -> a torch tensor of `dtype` rounded as the reference
    rounds (float8_e8m0fnu, which has no sign, from |a|)."""
    if dtype == "float8_e8m0fnu":
        a = np.abs(a)
    return ref.round_to(torch.from_numpy(a), getattr(torch, dtype))


def _to_jax(t):
    """A torch tensor on the CPU as a JAX array of the same type and
    bytes."""
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.float32:
        return jnp.asarray(t.numpy())
    raw = ref.bits(t).numpy().astype(np.uint8 if t.element_size() == 1
                                  else np.uint16)
    return jnp.asarray(raw.view(getattr(jnp, name)))


def _from_jax(x):
    """A JAX array as a torch tensor of the same type and bytes."""
    name = str(x.dtype)
    a = np.asarray(x)
    if name == "float32":
        return torch.from_numpy(a.copy())
    raw = a.view(np.uint8 if a.itemsize == 1 else np.int16).copy()
    return torch.from_numpy(raw).view(getattr(torch, name))


def _typed_inputs(shape_q, shape_kv, seed, dtypes):
    return [_typed(a, d) for a, d in zip(_inputs(shape_q, shape_kv, seed),
                                         dtypes)]


def _pallas_typed(pallas, q, k, v, **kw):
    return _from_jax(pallas.flash_attention(_to_jax(q), _to_jax(k),
                                            _to_jax(v), interpret=True,
                                            **kw))


@pytest.mark.parametrize("dtype", FLOAT8 + ["bfloat16", "float16"])
def test_round_to_matches_the_reference_astype(dtype):
    """The plain version's rounding of float32 to each narrow type against
    JAX's `astype`, the reference's last step, bit for bit (NaN as NaN):
    random float32 bit patterns, every value of the type, the values one
    float32 step on either side, the midpoints between neighbours and
    float32's own edges (zeros, infinities, NaN, denormals, the largest)."""
    if jnp is None:
        pytest.skip("needs jax for the reference")
    rng = np.random.default_rng(len(dtype))
    x = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    td = getattr(torch, dtype)
    if td.itemsize == 1:
        vals = torch.arange(256, dtype=torch.uint8).view(td).float().numpy()
        fin = np.unique(vals[np.isfinite(vals)])
        mids = ((fin[1:].astype(np.float64) + fin[:-1]) / 2).astype(
            np.float32)
        x = np.concatenate([x, fin, mids, np.nextafter(mids, np.inf),
                            np.nextafter(mids, -np.inf),
                            np.nextafter(fin, np.inf),
                            np.nextafter(fin, -np.inf)])
    x = np.concatenate([x, np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-39,
         3.4e38, -3.4e38], np.float32)]).astype(np.float32)
    want = _from_jax(jnp.asarray(x).astype(getattr(jnp, dtype)))
    got = ref.round_to(torch.from_numpy(x), td)
    assert got.dtype == td
    assert ref.rounding_steps(got, want) == 0
    if td.itemsize == 1:      # one NaN code per sign: the bits agree too
        assert torch.equal(ref.bits(got), ref.bits(want))


@pytest.mark.parametrize("dtype", FLOAT8)
def test_float8_table_is_the_reference_decoding(dtype):
    """`ref.decode_table` (the plain version's and the kernel's decoding
    of each float8 byte) against JAX's conversion of the same 256 bytes
    to float32."""
    if jnp is None:
        pytest.skip("needs jax for the reference")
    codes = torch.arange(256, dtype=torch.uint8)
    want = np.asarray(_to_jax(codes.view(getattr(torch, dtype))).astype(
        jnp.float32))
    got = ref.decode_table(getattr(torch, dtype), "cpu").numpy()
    np.testing.assert_array_equal(got, want)


# (B, H, Hkv, S, D, window, causal): MHA, GQA with a window, MQA without
# causal at a head dim off every width
_F8_SHAPES = [(1, 2, 2, 64, 32, 0, True), (2, 4, 2, 128, 64, 32, True),
              (1, 4, 1, 64, 48, 0, False)]


@pytest.mark.parametrize("B,H,Hkv,S,D,window,causal", _F8_SHAPES)
@pytest.mark.parametrize("dtype", FLOAT8)
def test_flash_attention_float8_matches_pallas(pallas, dtype, B, H, Hkv, S,
                                               D, window, causal):
    """q, k, v in one float8 format: the entry point and the plain version
    on CPU tensors against the Pallas kernel in interpret mode, the output
    in q's format within one rounding of it."""
    q, k, v = _typed_inputs((B, H, S, D), (B, Hkv, S, D), S + D,
                            [dtype] * 3)
    kw = dict(causal=causal, window=window)
    want = _pallas_typed(pallas, q, k, v, block_q=64, block_k=64, **kw)
    # D bytes a row, each a multiple of 16 here: the TMA takes them
    assert fa.route(q, k, v) == _rule([dtype] * 3, D, True)
    got = ops.flash_attention(q, k, v, block_q=64, block_k=64, **kw)
    assert got.dtype == q.dtype and want.dtype == q.dtype
    assert ref.rounding_steps(got, want) <= 1
    plain = ref.flash_attention_ref(q, k, v, **kw)
    assert ref.rounding_steps(plain, want) <= 1


_MIXED = [("bfloat16", "float8_e4m3fn", "float8_e4m3fn"),
          ("float32", "bfloat16", "bfloat16"),
          ("float16", "bfloat16", "float32"),
          ("float8_e5m2", "float16", "float32"),
          ("float32", "float8_e4m3fnuz", "float8_e5m2fnuz"),
          ("bfloat16", "float32", "float32"),
          ("float8_e4m3fn", "bfloat16", "bfloat16"),
          ("float16", "float8_e8m0fnu", "float8_e5m2"),
          ("float8_e8m0fnu", "float32", "float8_e8m0fnu"),
          # the tf32 sets without float32: bfloat16 beside float16, and
          # float16 beside e8m0fnu, with or without other float8 formats
          ("bfloat16", "float16", "float16"),
          ("float16", "bfloat16", "float16"),
          ("float16", "float16", "bfloat16"),
          ("bfloat16", "float16", "float8_e4m3fn"),
          ("float16", "float8_e8m0fnu", "float8_e8m0fnu"),
          ("float8_e8m0fnu", "float16", "float16")]


@pytest.mark.parametrize("dtypes", _MIXED, ids="-".join)
def test_flash_attention_mixed_types_match_pallas(pallas, dtypes):
    """q, k, v of different types (the Pallas kernel casts each to float32,
    the output takes q's type), GQA 2:1 with a window, against the Pallas
    kernel in interpret mode."""
    q, k, v = _typed_inputs((2, 4, 128, 40), (2, 2, 128, 40), 11, dtypes)
    want = _pallas_typed(pallas, q, k, v, window=48, block_q=64, block_k=64)
    # a float8 row of 40 bytes is no multiple of 16: the TMA refuses it
    assert fa.route(q, k, v) == _rule(
        dtypes, 40, not any(d.startswith("float8") for d in dtypes))
    got = ops.flash_attention(q, k, v, window=48, block_q=64, block_k=64)
    assert got.dtype == q.dtype
    close(got, want)
    close(ref.flash_attention_ref(q, k, v, window=48), want)


@pytest.mark.parametrize("window", [-1, -7])
@pytest.mark.parametrize("dtypes", [("float32",) * 3, ("bfloat16",) * 3,
                                    ("float8_e4m3fn",) * 3,
                                    ("bfloat16", "float8_e5m2", "float32")],
                         ids="-".join)
def test_negative_window_matches_pallas(pallas, dtypes, window):
    """The Pallas kernel reads a window <= 0 as none (`window > 0` guards
    its mask): the entry point at the same negative window against it,
    and against its own run without a window."""
    q, k, v = _typed_inputs((1, 4, 128, 32), (1, 2, 128, 32), -window,
                            dtypes)
    want = _pallas_typed(pallas, q, k, v, window=window, block_q=64,
                         block_k=64)
    got = ops.flash_attention(q, k, v, window=window, block_q=64,
                              block_k=64)
    close(got, want)
    assert torch.equal(ref.bits(got), ref.bits(ops.flash_attention(q, k, v)))


@pytest.mark.parametrize("kind", ["bshd_view", "start_off_1_byte",
                                  "last_dim_strided"])
def test_float8_layouts_compute_in_place(pallas, kind):
    """float8 q laid out as the model's (B,S,H,D) view, one byte past an
    aligned start, or with a column stride of 2: the route, the elements
    a copy moves, and the result against the Pallas kernel on the same
    logical values."""
    q, k, v = _typed_inputs((1, 4, 64, 32), (1, 2, 64, 32), 5,
                            ["float8_e4m3fn", "float8_e4m3fn", "bfloat16"])
    if kind == "bshd_view":
        lay = torch.empty((1, 64, 4, 32), dtype=q.dtype).transpose(1, 2)
    elif kind == "start_off_1_byte":
        lay = torch.empty(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    else:
        lay = torch.empty((1, 4, 64, 64), dtype=q.dtype)[..., ::2]
    lay.view(torch.uint8).copy_(q.view(torch.uint8))
    assert fa.route(lay, k, v) == _rule(
        ["float8_e4m3fn", "float8_e4m3fn", "bfloat16"], 32,
        kind == "bshd_view")
    assert fa.copy_elems(lay) == {"bshd_view": 16, "start_off_1_byte": 1,
                                  "last_dim_strided": 1}[kind]
    want = _pallas_typed(pallas, q, k, v, block_q=64, block_k=64)
    assert ref.rounding_steps(fa.flash_attention(lay, k, v), want) <= 1


@pytest.mark.parametrize("cname", ["bfloat16", "float16", "tf32"])
@pytest.mark.parametrize("dtype", FLOAT8 + ["bfloat16", "float16"])
def test_float8_decodes_exactly_into_the_compute_type(cname, dtype):
    """The routes' premise: every value of each operand's type is one of
    its compute type's, so the tensor cores read each operand exactly as
    the Pallas kernel does (in float32).  A 16-bit type is the compute
    type of a pair exactly where it holds every value of the other:
    float16 cannot hold e8m0fnu's 2^-127 to 2^127 nor bfloat16's range,
    bfloat16 not float16's 11-bit significands.  Those pairs compute in
    tf32, which holds every value of all seven types: a float32 whose low
    13 mantissa bits are zero (float16's subnormals are normal there,
    e8m0fnu's 2^-127 a subnormal)."""
    td = getattr(torch, dtype)
    if td.itemsize == 1:
        table = ref.decode_table(td, "cpu")
    else:                                      # every 16-bit pattern
        table = torch.arange(-32768, 32768).to(torch.int16).view(td).float()
    nan = torch.isnan(table)
    if cname == "tf32":
        low = table.view(torch.int32) & 0x1FFF
        assert int(low.masked_fill(nan, 0).abs().max()) == 0
        assert torch.equal(ref.round_tf32(table).masked_fill(nan, 0),
                           table.masked_fill(nan, 0))
        assert fa.compute_type(td, torch.bfloat16, torch.float16) == fa.TF32
        return
    there = table.to(getattr(torch, cname)).float()
    exact = bool(torch.equal(torch.isnan(there), nan) and torch.equal(
        there.masked_fill(nan, 0), table.masked_fill(nan, 0)))
    assert exact == ((cname, dtype) not in (("float16", "float8_e8m0fnu"),
                                            ("float16", "bfloat16"),
                                            ("bfloat16", "float16")))
    got = fa.compute_type(getattr(torch, cname), td)
    assert (got == getattr(torch, cname)) == exact
    if not exact:
        assert got == fa.TF32


_TYPES = ["float32", "bfloat16", "float16"] + FLOAT8


@pytest.mark.parametrize("layout", ["dense_64", "dense_40", "dense_320",
                                    "one_element_off", "dense_136"])
def test_route_over_every_type_triple(layout):
    """Every one of the 8^3 sets of q, k, v types routes as `_rule` says:
    at D=64 (every row a multiple of 16 bytes: wgmma or wgmma_tf32
    wherever there is a compute type), D=40 (a float8 row of 40 bytes
    keeps the TMA out: mma, or simt for tf32), D=320 (simt), D=136 (wgmma
    for a 16-bit compute type, simt for tf32, whose kernel ends at 128)
    and on views one element past an aligned start (mma, or simt for
    tf32); every set with float32 in it on simt."""
    D = {"dense_64": 64, "dense_40": 40, "dense_320": 320,
         "one_element_off": 64, "dense_136": 136}[layout]

    def tensor(heads, name):
        td = getattr(torch, name)
        n = heads * 16 * D
        if layout == "one_element_off":
            return torch.zeros(n + 1, dtype=td)[1:].view(1, heads, 16, D)
        return torch.zeros((1, heads, 16, D), dtype=td)

    for names in itertools.product(_TYPES, repeat=3):
        q, k, v = tensor(4, names[0]), tensor(2, names[1]), tensor(2, names[2])
        tma = layout != "one_element_off" and all(
            D * t.element_size() % 16 == 0 for t in (q, k, v))
        want = _rule(names, D, tma)
        assert fa.route(q, k, v) == want, names
        if "float32" in names:
            assert want == "simt"
        if want == "wgmma_tf32":
            assert fa.compute_type(*(t.dtype for t in (q, k, v))) == fa.TF32


@pytest.mark.parametrize("D,tma,want", [
    (8, True, "wgmma_tf32"), (64, True, "wgmma_tf32"),
    (72, True, "wgmma_tf32"), (128, True, "wgmma_tf32"),
    (136, True, "simt"), (256, True, "simt"), (100, True, "simt"),
    (64, False, "simt"), (512, True, "simt")])
def test_tf32_variant_and_width(D, tma, want):
    """The tf32 kernel takes D % 8 == 0 up to 128 on the TMA's layouts, at
    width 64 up to D = 64 and 128 above; the PerTensor simt kernel the
    rest of the tf32 sets."""
    assert fa.variant(fa.TF32, D, tma) == want
    if want == "wgmma_tf32":
        assert fa.width(want, D) == (64 if D <= 64 else 128)
    with pytest.raises(ValueError):
        fa.variant(fa.TF32, 0)


def _tf32_numpy(x):
    """float32 `x` rounded to tf32 in float64 arithmetic: the multiple of
    the tf32 spacing at |x| nearest to x, ties away from zero, overflow to
    infinity (float32's largest exponent), NaN and infinities kept."""
    with np.errstate(invalid="ignore"):      # signalling NaN patterns
        x64 = x.astype(np.float64)
    out = x64.copy()
    fin = np.isfinite(x64) & (x64 != 0)
    e = np.floor(np.log2(np.abs(x64[fin])))
    spacing = 2.0 ** (np.maximum(e, -126) - 10)
    out[fin] = np.sign(x64[fin]) * np.floor(np.abs(x64[fin]) / spacing
                                            + 0.5) * spacing
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


def test_round_tf32_is_to_nearest_ties_away():
    """The plain version's rounding of P for the tf32 route
    (`ref.round_tf32`, the kernel's cvt.rna.tf32.f32) against the same
    rounding in float64: random float32 bit patterns, the midpoints
    between neighbouring tf32 values (ties, which go away from zero) and
    one float32 step on either side, subnormals and float32's edges."""
    rng = np.random.default_rng(25)
    x = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(
        np.uint32)
    ties = (x & ~np.uint32(0x1FFF)) | np.uint32(0x1000)
    x = np.concatenate([x, ties, ties + 1, ties - 1]).view(np.float32)
    x = np.concatenate([x, np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-39,
         2.0 ** -127, 3.4e38, -3.4e38, 1.0, 1.0 + 2.0 ** -11,
         1.0 + 3 * 2.0 ** -11, 0.5 - 2.0 ** -25], np.float32)])
    got = ref.round_tf32(torch.from_numpy(x)).numpy()
    want = _tf32_numpy(x)
    np.testing.assert_array_equal(got.view(np.uint32)[~np.isnan(x)],
                                  want.view(np.uint32)[~np.isnan(x)])
    assert np.isnan(got[np.isnan(x)]).all()
    assert got[-3] == 1.0 + 2.0 ** -10 and got[-2] == 1.0 + 2.0 ** -9


# the unit roundoff of each compute type: 2^-p for p significant bits (8
# bfloat16, 11 float16 and tf32), the most a rounding moves a weight
UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11,
                 fa.TF32: 2.0 ** -11}


@pytest.mark.parametrize("round_p", [torch.bfloat16, torch.float16,
                                     fa.TF32])
def test_plain_version_rounds_p_within_the_routes_bracket(round_p):
    """The plain version with P rounded as a tensor-core route rounds it
    (`round_p`) lies within the unit roundoff of C times |v|_P of the
    plain version in float32, element by element (each weight moves by at
    most that share), which the route's bracket U_C covers; with one key
    a row every weight is exactly 1 and the two agree bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in
               _inputs((2, 4, 96, 32), (2, 2, 96, 32), 9))
    want = ref.flash_attention_ref(q, k, v, window=40)
    got = ref.flash_attention_ref(q, k, v, window=40, round_p=round_p)
    mean_v = ref.flash_attention_ref(q, k, v.abs(), window=40)
    assert not torch.equal(got, want)
    assert UNIT_ROUNDOFF[round_p] <= U_C[round_p]
    assert ((got - want).abs() <= UNIT_ROUNDOFF[round_p] * mean_v
            + 1e-7).all()
    one = [t[:, :, :1] for t in (q, k, v)]
    assert torch.equal(ref.flash_attention_ref(*one, round_p=round_p),
                       ref.flash_attention_ref(*one))


def test_float8_copy_widths_are_cp_async_sizes():
    """A 1-byte tensor moves 16, 8 or 4 bytes a copy, or goes element by
    element: never 2 bytes, which cp.async cannot copy."""
    base = torch.zeros(4096, dtype=torch.float8_e5m2)
    for off, D, want in ((0, 32, 16), (8, 32, 8), (4, 32, 4), (2, 32, 1),
                         (0, 40, 8), (0, 36, 4), (0, 34, 1)):
        t = base[off:off + 2 * D].view(1, 1, 2, D)
        assert fa.copy_elems(t) == want, (off, D)


def test_dtype_keys_name_a_mix_by_its_four_types():
    f8, bf = torch.float8_e4m3fn, torch.bfloat16
    assert fa.dtype_key("wgmma", bf, bf, bf, bf) == "wgmma/bfloat16"
    assert fa.dtype_key("simt", f8, f8, f8, f8) == "simt/float8_e4m3fn"
    assert fa.dtype_key("simt", bf, f8, f8, bf) == \
        "simt/bfloat16,float8_e4m3fn,float8_e4m3fn,bfloat16"


@pytest.mark.parametrize("dtypes", [("int32",) * 3, ("float64",) * 3,
                                    ("bfloat16", "int8", "bfloat16"),
                                    ("float32", "float32", "float64")],
                         ids="-".join)
def test_integer_and_float64_inputs_still_raise(dtypes):
    """No caller passes integer q, k, v (the one input the Pallas kernel
    computes and the port refuses, ROADMAP Queue 3), and JAX narrows a
    float64 array to float32 before the kernel sees it."""
    q, k, v = (torch.zeros(s).to(getattr(torch, d)) for s, d in
               zip(((1, 2, 8, 16), (1, 1, 8, 16), (1, 1, 8, 16)), dtypes))
    with pytest.raises(TypeError):
        fa.flash_attention(q, k, v)


def _card_qkv(B, H, Hkv, Sq, Sk, D, dtypes, seed, dev, layout="dense"):
    """q (B,H,Sq,D), k, v (B,Hkv,Sk,D) drawn on the card from `seed`, q, k
    and v of the types named in `dtypes` (a float8 tensor rounded from
    normal draws as the plain version rounds; float8_e8m0fnu, which has
    no sign and no zero, from their magnitudes kept at 2^-126 or more: a
    draw of 0 encodes as NaN), laid out as `layout`: "dense"; "bshd", the
    (B,H,S,D) views of (B,S,H,D) tensors, as the model passes them; or
    one the TMA cannot take: "col2" a last dimension of stride 2,
    "row_pad4" rows D + 4 elements apart, "off1" a start one element past
    an aligned one, "perm" the dense (B,H,S,D) view of a (B,S,D,H) tensor
    (whose output, empty_like(q), takes the same strides)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape, view = {
        "dense": (lambda h, S: (B, h, S, D), lambda x, h, S: x),
        "bshd": (lambda h, S: (B, S, h, D), lambda x, h, S: x.transpose(1, 2)),
        "col2": (lambda h, S: (B, h, S, 2 * D), lambda x, h, S: x[..., ::2]),
        "row_pad4": (lambda h, S: (B, h, S, D + 4),
                     lambda x, h, S: x[..., :D]),
        "off1": (lambda h, S: (B * h * S * D + 1,),
                 lambda x, h, S: x[1:].view(B, h, S, D)),
        "perm": (lambda h, S: (B, S, D, h),
                 lambda x, h, S: x.permute(0, 3, 1, 2))}[layout]

    def make(heads, S, name):
        x = torch.randn(shape(heads, S), generator=g, device=dev)
        if name == "float8_e8m0fnu":
            x = x.abs().clamp_min(2.0 ** -126)
        return view(ref.round_to(x, getattr(torch, name)), heads, S)
    return (make(H, Sq, dtypes[0]), make(Hkv, Sk, dtypes[1]),
            make(Hkv, Sk, dtypes[2]))


# K3's edges, (B, H, Hkv, Sq, Sk, D, window, causal): S not a multiple of
# the wgmma kernel's 128-row tiles, Sq < Sk, a window of 1024 at S=4096,
# gemma3's D=256 and zamba2's D=112 at S=4096; in 16-bit types those with
# Sk >= 1000 are also held to SCALED
EDGES = [(1, 4, 2, 100, 100, 128, 0, True),
         (1, 32, 8, 4000, 4000, 128, 0, True),
         (2, 32, 8, 1000, 4096, 128, 0, True),
         (1, 8, 2, 128, 4000, 256, 100, True),
         (1, 32, 8, 4096, 4096, 128, 1024, True),
         (1, 16, 8, 4096, 4096, 256, 0, True),
         (1, 8, 8, 4000, 4000, 64, 1024, False),
         (1, 32, 32, 4096, 4096, 112, 0, True),
         (1, 4, 4, 4000, 4000, 112, 1024, True)]
# head dims beyond the models' 16-256, every branch of `variant`: wgmma at
# width 64 (8-56) and on mostly empty last TMA boxes, mma at D % 8 != 0 at
# each width (20, 100, 250), simt for 16-bit types above 256 and in
# column chunks (up to 1024)
NEW_HEAD_DIMS = (8, 20, 24, 40, 48, 56, 80, 96, 100, 120, 136, 160, 192,
                 200, 250, 320, 512, 520, 768, 1024)
# a head dim of each compiled kernel: wgmma's widths and Q K^T step counts
# (most leave a last TMA box mostly empty), mma and simt at each width - 4
# (no multiple of 8), 16-bit types on simt (300)
KERNEL_DIMS = sorted({8, 24, 40, 56, 72, 96, 112, 128, 136, 256, 300,
                      *(w - 4 for w in fa.WIDTHS["mma"] + fa.WIDTHS["simt"])})
DTYPES = ["float32", "bfloat16", "float16"]

CARD_CASES = [
    (1, 1, 1, 64, 64, 16, 0, True),
    (2, 4, 2, 192, 192, 64, 100, True),
    (2, 8, 1, 128, 128, 256, 32, False),
    (2, 32, 8, 100, 1024, 128, 0, True),
    (1, 4, 2, 256, 256, 32, 0, False),
    # the wgmma kernel's edges: S not a multiple of its 128-row tiles,
    # Sq < Sk, a window of 1024 at S=4096, D=256 at S=4096
    (1, 4, 2, 100, 100, 128, 0, True),
    (2, 4, 2, 192, 192, 256, 0, True),
    (1, 8, 2, 4000, 4000, 128, 0, True),
    (1, 8, 2, 1000, 4096, 64, 0, True),
    (1, 8, 2, 4096, 4096, 128, 1024, True),
    (1, 4, 2, 4096, 4096, 256, 0, True),
    # D=112 (zamba2's shared block): the D=128 pipeline on TMA's zero fill
    (1, 4, 4, 100, 100, 112, 0, True),
    (2, 4, 4, 300, 300, 112, 64, False),
    (1, 32, 32, 1024, 1024, 112, 0, True),
    # every branch of `variant` beyond the models' head dims: wgmma at
    # width 64 (8, 40, 48), on mostly empty last boxes (80, 96, 120, 136,
    # 160, 200), mma at D % 8 != 0 (100), simt for 16-bit types above 256
    # and in column chunks (320, 512, 520, 1024)
    (1, 4, 2, 200, 200, 8, 0, True),
    (2, 4, 1, 192, 300, 40, 64, True),
    (1, 8, 2, 256, 256, 48, 0, False),
    (1, 4, 2, 300, 300, 80, 100, False),
    (2, 8, 2, 1024, 1024, 96, 0, True),
    (1, 4, 4, 130, 130, 100, 0, True),
    (1, 4, 2, 100, 400, 120, 0, True),
    (1, 4, 2, 300, 300, 136, 64, True),
    (1, 2, 1, 256, 256, 160, 0, True),
    (1, 4, 2, 200, 200, 200, 50, True),
    (1, 2, 1, 130, 130, 320, 0, True),
    (1, 2, 2, 100, 100, 512, 0, True),
    (1, 2, 1, 130, 130, 520, 0, True),
    (1, 4, 2, 100, 300, 1024, 64, True),
]
# the grid: B, (H, Hkv), S, D, window and causal; zamba2's D=112 on its
# own grid; Sq != Sk (Sq > Sk too, where leading rows keep no key)
CARD_CASES += [(B, H, Hkv, S, S, D, w, c) for B in (1, 2)
               for H, Hkv in ((1, 1), (4, 2), (8, 1), (32, 8))
               for S in (64, 128, 192, 256, 1024)
               for D in (16, 32, 64, 128, 256)
               for w in (0, 32, 100) for c in (True, False)]
CARD_CASES += [(B, H, Hkv, S, S, 112, w, c) for B in (1, 2)
               for H, Hkv in ((1, 1), (4, 4), (32, 32), (8, 2))
               for S in (64, 192, 1024) for w in (0, 100)
               for c in (True, False)]
CARD_CASES += [(2, H, Hkv, Sq, Sk, D, w, c)
               for Sq, Sk in ((1, 128), (64, 256), (100, 1024), (192, 1024),
                              (128, 64))
               for H, Hkv, D in ((4, 2, 64), (4, 4, 112), (32, 8, 128),
                                 (8, 1, 256))
               for w in (0, 100) for c in (True, False)]
CARD_CASES += EDGES
CARD_CASES += [(B, H, Hkv, Sq, Sk, D, w, c) for D in NEW_HEAD_DIMS
               for B, H, Hkv, Sq, Sk, w, c in (
                   (1, 4, 2, 192, 192, 0, True),
                   (2, 4, 4, 300, 300, 100, True),
                   (1, 8, 2, 100, 257, 0, True),
                   (1, 2, 1, 1024, 1024, 0, True),
                   (1, 4, 2, 128, 64, 0, True))]
CARD_CASES += [(1, 2, 1, 300, 300, D, 0, True) for D in KERNEL_DIMS]
CARD_CASES = list(dict.fromkeys(CARD_CASES))


@pytest.mark.parametrize(
    "dtype,B,H,Hkv,Sq,Sk,D,window,causal,held",
    [(d, *c, "scaled" if d != "float32" and c in EDGES and c[4] >= 1000
      else "tol") for c in CARD_CASES for d in DTYPES])
def test_flash_kernel_matches_plain_on_card(card, dtype, B, H, Hkv,
                                            Sq, Sk, D, window, causal, held):
    """Each variant against the plain version on dense inputs: within TOL,
    and SCALED too (`held`) at long sequences; rows that keep no key
    (Sq > Sk, causal) are 0."""
    q, k, v = _card_qkv(B, H, Hkv, Sq, Sk, D, (dtype,) * 3, Sq * D,
                        card)
    launches = dict(fa.VARIANT_LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    name = fa.variant(q.dtype, D)
    assert fa.VARIANT_LAUNCHES[name] == launches[name] + 1
    assert fa.DTYPE_LAUNCHES[f"{name}/{dtype}"] >= 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert (got.float() - want.float()).abs().max() < TOL[dtype]
    if held == "scaled":
        assert scaled_ok(got, q, k, v, causal=causal, window=window)
    if causal and Sq > Sk:
        assert got[:, :, :Sq - Sk].abs().max() == 0


@pytest.mark.parametrize(
    "dtype,B,H,Hkv,Sq,Sk,D,window,causal,scale,held",
    [(d, 2, 8, 2, 300, 300, D, 100, True, None, "tol") for d in DTYPES
     for D in (32, 112, 128, 256, 48, 100, 136, 320)]
    + [(d, *c, None, "scaled" if d != "float32" and c[4] >= 1000
        else "tol") for c in EDGES for d in DTYPES]
    + [(d, 2, 4, 2, S, S, D, 0, True, None, "tol") for d in DTYPES
       for S in (100, 192) for D in (16, 32, 64, 112, 128, 256)]
    + [(d, 2, 4, 2, 130, 130, D, 64, False, None, "tol") for d in DTYPES
       for D in NEW_HEAD_DIMS]
    # K3 as Granite 4.0-H Small's attention calls it: H = 32, Hkv = 8,
    # D = 128, softmax scale 1/128 (attention_multiplier)
    + [("bfloat16", 1, 32, 8, S, S, 128, 0, True, 0.0078125, "scaled_only")
       for S in (2048, 4096, 6144, 8192)])
def test_flash_kernel_strided_views_on_card(card, dtype, B, H, Hkv,
                                            Sq, Sk, D, window, causal, scale,
                                            held):
    """The (B,H,S,D) views of (B,S,H,D) tensors in and out, as the model
    passes them, held as on dense inputs."""
    q, k, v = _card_qkv(B, H, Hkv, Sq, Sk, D, (dtype,) * 3, D + Sk,
                        card, "bshd")
    kw = dict(causal=causal, window=window, scale=scale)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()
    if held != "scaled_only":
        want = ref.flash_attention_ref(q, k, v, **kw)
        assert (got.float() - want.float()).abs().max() < TOL[dtype]
    if held != "tol":
        assert scaled_ok(got, q, k, v, **kw)


# one unit of the type's rounding of an output, relative: where outputs
# reach past 2 (few keys a row, over many rows) one rounding of a bf16
# output exceeds the absolute TOL
REL = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 100])
def test_flash_kernel_many_heads_on_card(card, dtype, D):
    """B*H = 65,600, above the 65,535 of a grid's y dimension: every
    kernel puts b*H + h in x."""
    q, k, v = _card_qkv(2, 32800, 8200, 16, 16, D, (dtype,) * 3, D,
                        card)
    got = fa.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v).float()
    torch.cuda.synchronize()
    assert ((got.float() - want).abs()
            <= TOL[dtype] + REL[dtype] * want.abs()).all()
    assert scaled_ok(got, q, k, v)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["col2", "row_pad4", "off1", "perm"])
@pytest.mark.parametrize("D", [20, 32, 100, 128, 64, 320])
@pytest.mark.parametrize("Sq,Sk,window,causal", [
    (300, 300, 100, True), (300, 300, 0, True), (192, 257, 100, False)])
def test_flash_kernel_layouts_the_tma_cannot_take_on_card(
        card, dtype, kind, D, Sq, Sk, window, causal):
    """The layouts the TMA cannot take, read in place by mma (16-bit up
    to D = 256) and simt (float32, and above 256)."""
    q, k, v = _card_qkv(2, 4, 2, Sq, Sk, D, (dtype,) * 3, D, card,
                        kind)
    assert fa.route(q, k, v) == ("simt" if dtype == "float32" or D > 256
                                 else "mma")
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() < TOL[dtype]


# each float8 format alone and each mix, at shapes where the types take
# each route: the tensor cores where they have a compute type (wgmma at
# D=64 and 128, mma at D=40 and 136, wgmma_tf32 for the tf32 sets) and the
# PerTensor simt kernel otherwise (float32 in the set, D=320, the tf32
# sets past D=128); GQA, windows, Sq != Sk, a longer sequence
CARD_TYPES = [(d,) * 3 for d in FLOAT8] + _MIXED + [
    ("float8_e4m3fnuz", "float8_e4m3fnuz", "bfloat16"),
    ("bfloat16", "bfloat16", "float8_e5m2fnuz"),
    ("float16", "float8_e5m2", "float8_e5m2"),
    ("float8_e4m3fn", "float16", "float16"),
    ("float16", "bfloat16", "bfloat16"),
    ("float8_e5m2fnuz", "bfloat16", "float16")]
TYPE_SHAPES = [(2, 4, 2, 192, 192, 64, 100, True),
               (1, 8, 2, 100, 300, 136, 0, True),
               (2, 4, 4, 130, 130, 320, 0, False),
               (1, 4, 2, 192, 192, 64, 100, True),
               (2, 8, 2, 300, 300, 128, 0, True),
               (1, 4, 4, 100, 257, 40, 0, False),
               (2, 4, 1, 130, 130, 320, 64, True),
               (1, 32, 8, 1024, 1024, 128, 0, True)]
# one short call of each kernel that takes these types: the tf32 kernel at
# both widths on q of each kind; PerTensor simt at each column chunk and
# on each float8 format beside float32; and each wgmma and mma kernel
# that decodes float8, for each compute type, the sets taken in turn
FIRST_CALLS = [
    (("bfloat16", "float16", "float16"), 64),
    (("float16", "bfloat16", "bfloat16"), 128),
    (("float16", "float8_e8m0fnu", "float8_e5m2"), 32),
    (("float8_e4m3fn", "float16", "bfloat16"), 96),
    (("float8_e8m0fnu", "float16", "float8_e4m3fnuz"), 112)]
FIRST_CALLS += [(("float32", "bfloat16", "bfloat16"), w - 4)
                for w in fa.WIDTHS["simt"]]
FIRST_CALLS += [((d, d, "float32"), 60) for d in FLOAT8]
for _sets in ((("bfloat16", "float8_e4m3fn", "float8_e4m3fn"),
               ("float8_e4m3fn",) * 3,
               ("float8_e8m0fnu", "bfloat16", "float8_e4m3fnuz"),
               ("float8_e5m2fnuz", "float8_e5m2", "bfloat16")),
              (("float16", "float8_e5m2", "float8_e5m2"),
               ("float8_e4m3fn", "float16", "float16"),
               ("float8_e4m3fnuz", "float8_e5m2fnuz", "float16"))):
    FIRST_CALLS += [(_sets[i % len(_sets)], D) for i, D in enumerate(
        [16, 32, 48, 64, 80, 96, 112, 128, 144, 256]
        + [w - 4 for w in fa.WIDTHS["mma"]])]


@pytest.mark.parametrize(
    "dtypes,B,H,Hkv,Sq,Sk,D,window,causal,layout",
    [(t, *s, "dense") for t in CARD_TYPES for s in TYPE_SHAPES]
    # float8 as the model's (B,S,H,D) view, one byte past an aligned
    # start, and with a column stride of 2
    + [((d, d, "bfloat16"), 2, 4, 2, 192, 257, 64, 100, True, lay)
       for d in ("float8_e4m3fn", "float8_e5m2")
       for lay in ("bshd", "off1", "col2")]
    + [(t, 1, 2, 1, 300, 300, D, 0, True, "dense") for t, D in FIRST_CALLS],
    ids=lambda p: "-".join(p) if isinstance(p, tuple) else None)
def test_flash_kernel_types_on_card(card, dtypes, B, H, Hkv, Sq, Sk,
                                    D, window, causal, layout):
    """Each float8 format and each mix against the plain version on the
    card (`close_on_route`), launched once on the route `_rule` names."""
    q, k, v = _card_qkv(B, H, Hkv, Sq, Sk, D, dtypes, Sq + D, card,
                        layout)
    tma = layout in ("dense", "bshd") and all(
        D * t.element_size() % 16 == 0 for t in (q, k, v))
    route = fa.route(q, k, v)
    assert route == _rule(dtypes, D, tma)
    key = fa.dtype_key(route, q.dtype, k.dtype, v.dtype, q.dtype)
    before = fa.DTYPE_LAUNCHES.get(key, 0)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.DTYPE_LAUNCHES[key] == before + 1
    close_on_route(got, q, k, v, causal=causal, window=window)


def _zeros(shape, name, dev):
    """Zeros of type `name`: byte 0 for a 1-byte type (2^-127 in
    float8_e8m0fnu, which has no zero)."""
    td = getattr(torch, name)
    if td.itemsize == 1:
        return torch.zeros(shape, dtype=torch.uint8, device=dev).view(td)
    return torch.zeros(shape, dtype=td, device=dev)


def _same_bits(got, want):
    """Bit for bit, but the sign of a NaN, which the products need not
    keep."""
    nan = torch.isnan(ref.decode(want))
    return bool(torch.equal(torch.isnan(ref.decode(got)), nan)
                and torch.equal(ref.bits(got).masked_fill(nan, 0),
                                ref.bits(want).masked_fill(nan, 0)))


@pytest.mark.parametrize(
    "dtype,k_type,v_type",
    [(d, "float32", "float32") for d in FLOAT8 + ["bfloat16", "float16"]]
    # through the tensor cores: every bfloat16 pattern rounded to each
    # float8 format by wgmma, every float16 pattern by the tf32 kernel,
    # and every bfloat16 and float16 pattern passed through it
    + [(d, d, "bfloat16") for d in FLOAT8]
    + [(d, "bfloat16", "float16") for d in FLOAT8]
    + [("bfloat16", "float16", "bfloat16"), ("float16", "bfloat16",
                                             "float16")])
def test_kernel_rounds_outputs_as_the_plain_version_on_card(
        card, dtype, k_type, v_type):
    """One key a row (Sk = 1, q and k zero: every weight exactly 1), so
    the output is v itself rounded to q's type: the kernel's encoder
    against `ref.round_to`, over random float32 bit patterns and
    float32's edges (simt), or every pattern of a 16-bit v (the tensor
    cores; subnormals included, which a flushing tensor core would
    break), value for value, and bit for bit but the sign of a NaN for
    float8 and on the tensor cores."""
    if v_type == "float32":
        rng = np.random.default_rng(3)
        x = rng.integers(0, 2 ** 32, 4096 * 256, dtype=np.uint64).astype(
            np.uint32).view(np.float32)
        x[:10] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-39,
                  3.4e38, 464.0]
        v = torch.from_numpy(x).view(1, 4096, 1, 256).to(card)
    else:
        v = torch.arange(-32768, 32768, dtype=torch.int32).to(
            torch.int16).view(getattr(torch, v_type)).view(
                1, 2048, 1, 32).to(card)
    q = _zeros(v.shape, dtype, card)
    k = _zeros(v.shape, k_type, card)
    assert fa.route(q, k, v) == _rule([dtype, k_type, v_type], v.shape[-1],
                                      True)
    got = fa.flash_attention(q, k, v).cpu()
    # the sum of products starts at +0, so -0 comes out +0
    want = ref.round_to(v.float().cpu() + 0.0, q.dtype).view(got.shape)
    assert ref.rounding_steps(got, want) == 0
    if q.dtype.itemsize == 1 or fa.route(q, k, v) != "simt":
        assert _same_bits(got, want)


@pytest.mark.parametrize("q_type,k_type", [
    ("float32", "float32"), ("bfloat16", "same"), ("float16", "same"),
    ("bfloat16", "float16"), ("float16", "float8_e8m0fnu")])
@pytest.mark.parametrize("dtype", FLOAT8)
def test_kernel_decodes_every_float8_byte_on_card(card, dtype,
                                                  q_type, k_type):
    """v holds each of the 256 bytes once, Sk = 1 and q, k zeros: the
    output is the table's value of each byte in q's type, through simt
    (q, k float32), the wgmma kernel (q bfloat16 or float16 beside k of
    the format) and the tf32 kernel (q bfloat16 beside k float16, q
    float16 beside k e8m0fnu); on the tensor cores bit for bit."""
    codes = torch.arange(256, dtype=torch.uint8).view(getattr(torch, dtype))
    v = codes.view(1, 8, 1, 32).to(card)
    q = _zeros(v.shape, q_type, card)
    k = _zeros(v.shape, dtype if k_type == "same" else k_type, card)
    route = fa.route(q, k, v)
    assert route == _rule([q_type, str(k.dtype).removeprefix("torch."),
                           dtype], 32, True)
    got = fa.flash_attention(q, k, v).cpu().reshape(-1)
    want = ref.round_to(codes.float() + 0.0, q.dtype)      # -0 as +0
    assert torch.equal(torch.isnan(ref.decode(got)),
                       torch.isnan(ref.decode(want)))
    assert torch.equal(ref.decode(got).nan_to_num(0.5),
                       ref.decode(want).nan_to_num(0.5))
    if route != "simt":
        assert _same_bits(got, want)


@pytest.mark.parametrize("window", [-1, -7])
@pytest.mark.parametrize("dtypes", [("bfloat16",) * 3, ("float32",) * 3,
                                    ("float8_e4m3fn",) * 3,
                                    ("float16",) * 3,
                                    ("bfloat16", "float8_e4m3fn",
                                     "float8_e4m3fn")],
                         ids="-".join)
@pytest.mark.parametrize("D", [64, 100])
def test_negative_window_on_card(card, dtypes, window, D):
    q, k, v = _card_qkv(2, 8, 2, 300, 300, D, dtypes, 1, card)
    got = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    close_on_route(got, q, k, v, window=0)
