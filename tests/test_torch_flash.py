"""The port's flash attention (K3) against the JAX reference.

The same numpy inputs, made from a seed, go through the Pallas kernel of
`repro.kernels.flash_attention` (in interpret mode, as the reference's own
tests run it) and through the port: its plain version
`ref.flash_attention_ref` and its entry point `ops.flash_attention` on CPU
tensors.  Tolerances are the reference's own (`tests/test_kernels.py`):
2e-5 in float32, 2e-2 in bfloat16 (one rounding of the output).  The CUDA
kernel itself is held against the plain version on the card by the
`card` test at the end and by `chip_smoke.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

try:                                     # the card test needs no JAX
    import jax.numpy as jnp
    from repro.kernels import flash_attention as jfa
except ImportError:                      # pragma: no cover
    jnp = jfa = None

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(torch.zeros((1, 4, 8, 48)),
                           torch.zeros((1, 2, 8, 48)),
                           torch.zeros((1, 2, 8, 48)))
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros((1, 3, 8, 32)),
                           torch.zeros((1, 3, 8, 32)))
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv, window=-1)

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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_variant_is_the_designed_kernel(dtype, D):
    want = {"float32": "simt", "bfloat16": "wgmma" if D >= 64 else "mma"}
    assert fa.variant(getattr(torch, dtype), D) == want[dtype]
    assert fa.variant(getattr(torch, dtype), D) in fa.VARIANTS


@pytest.mark.parametrize("dtype,D,error", [
    ("float16", 128, TypeError), ("float64", 64, TypeError),
    ("int32", 128, TypeError), ("bfloat16", 48, ValueError),
    ("float32", 8, ValueError), ("bfloat16", 512, ValueError),
])
def test_variant_raises_on_other_inputs(dtype, D, error):
    with pytest.raises(error):
        fa.variant(getattr(torch, dtype), D)


def _strided(kind):
    """A q of shape (1, 4, 64, 32) laid out as `kind`."""
    if kind == "last_dim_strided":
        return torch.zeros((1, 4, 64, 64))[..., ::2]
    if kind == "row_stride_72_bytes":          # bf16 rows 36 apart
        return torch.zeros((1, 4, 64, 36), dtype=torch.bfloat16)[..., :32]
    if kind == "start_off_16_bytes":
        return torch.zeros(4 * 64 * 32 + 1)[1:].view(1, 4, 64, 32)
    if kind == "row_stride_80_bytes":          # bf16 rows 40 apart
        return torch.zeros((1, 4, 64, 40), dtype=torch.bfloat16)[..., :32]
    if kind == "bshd_view":
        return torch.zeros((1, 64, 4, 32)).transpose(1, 2)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind,ok", [
    ("last_dim_strided", False), ("row_stride_72_bytes", False),
    ("start_off_16_bytes", False), ("row_stride_80_bytes", True),
    ("bshd_view", True),
])
def test_wrapper_refuses_strides_the_tma_cannot_take(kind, ok):
    """The card's TMA needs a dense last dimension, strides of 16-byte
    multiples and a 16-byte aligned start; the wrapper holds CPU tensors
    to the same rules, so the CPU tests show what the card refuses."""
    q = _strided(kind)
    kv = torch.randn((1, 2, 64, 32)).to(q.dtype)
    if not ok:
        with pytest.raises(ValueError):
            fa.layout_strides(q, "q")
        with pytest.raises(ValueError):
            fa.flash_attention(q, kv, kv)
        return
    assert fa.layout_strides(q, "q") == [32] + list(q.stride()[1:3])
    q.copy_(torch.randn(q.shape).to(q.dtype))
    want = fa.flash_attention(q.contiguous(), kv, kv).float()
    got = fa.flash_attention(q, kv, kv).float()
    assert (got - want).abs().max() < TOL[str(q.dtype).split(".")[1]]


def test_size_one_dims_take_any_stride():
    q = torch.randn((1, 4, 1, 32)).as_strided((1, 4, 1, 32), (3, 32, 5, 1))
    kv = torch.randn((1, 2, 8, 32))
    assert fa.layout_strides(q, "q") == [32, 32, 32]
    assert fa.flash_attention(q, kv, kv).shape == q.shape


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


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
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,window,causal", CARD_CASES)
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, B, H, Hkv,
                                            Sq, Sk, D, window, causal):
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda_device, td) for a in
               _inputs((B, H, Sq, D), (B, Hkv, Sk, D), Sq * D))
    launches = dict(fa.VARIANT_LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    name = fa.variant(td, D)
    assert fa.VARIANT_LAUNCHES[name] == launches[name] + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert (got.float() - want.float()).abs().max() < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 128, 256])
def test_flash_kernel_strided_views_on_card(cuda_device, dtype, D):
    arrays = _inputs((2, 8, 300, D), (2, 2, 300, D), D)
    q, k, v = (t.to(cuda_device) for t in _bshd_views(arrays, dtype))
    got = fa.flash_attention(q, k, v, window=100)
    want = ref.flash_attention_ref(q, k, v, window=100)
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()
    assert (got.float() - want.float()).abs().max() < TOL[dtype]
