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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,window,causal", [
    (1, 1, 1, 64, 64, 16, 0, True),
    (2, 4, 2, 192, 192, 64, 100, True),
    (2, 8, 1, 128, 128, 256, 32, False),
    (2, 32, 8, 100, 1024, 128, 0, True),
    (1, 4, 2, 256, 256, 32, 0, False),
])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, B, H, Hkv,
                                            Sq, Sk, D, window, causal):
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda_device, td) for a in
               _inputs((B, H, Sq, D), (B, Hkv, Sk, D), Sq * D))
    launches = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == launches + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert (got.float() - want.float()).abs().max() < TOL[dtype]
