"""The port's dense transformer, serving steps and server against the JAX
reference.

Parameters come from `repro.models.layers.tree_init` and cross to the port
through the numpy bridge (`repro_torch.models.convert`); token batches are
made with numpy from a seed.  The reference's flash path runs its Pallas
kernel in interpret mode (its default off a TPU); the port's runs the
kernel's plain version, since these tensors lie on the CPU.

Tolerances: float32 compute agrees to 1e-5 (the two packages sum in other
orders); bfloat16 compute to 3 % of the largest logit, since the two
frameworks round to bfloat16 at other places (about 2 bf16 ulps of the
largest logit were seen at these sizes).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, get_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models.config import RunConfig  # noqa: E402
from repro.train import serve as jserve  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as port_fa  # noqa: E402
from repro_torch.models import config as port_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.train import serve as tserve  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

DENSE = ["yi-9b", "gemma3-12b", "qwen3-4b", "qwen2-7b"]
BF16_REL = 3e-2


def _params(arch, seed=0):
    cfg = get_smoke_config(arch)
    jp = JL.tree_init(JR.param_defs(cfg), jax.random.PRNGKey(seed))
    return cfg, port_smoke(arch), jp, convert.from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")


def _rcs(**kw):
    """The same RunConfig in both packages."""
    return RunConfig(**kw), port_config.RunConfig(**kw)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("impl", ["ref", "chunked", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_unembed_match_reference_f32(arch, impl):
    cfg, tcfg, jp, tp = _params(arch)
    rc, trc = _rcs(seq_len=64, global_batch=2, kind="prefill",
                   attn_impl=impl, attn_chunk=16, compute_dtype="float32",
                   remat="none")
    toks = _tokens(cfg, 2, 64, 1)
    x, plen, _, _, aux = JR.forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                                    rc)
    want = _f32(JR.unembed(cfg, jp, x, rc))
    tx, tplen, _, _, taux = TR.forward(
        tcfg, tp, {"tokens": torch.from_numpy(toks)}, trc)
    got = _f32(TR.unembed(tcfg, tp, tx, trc))
    assert tplen == plen == 0 and float(taux) == float(aux) == 0.0
    assert np.abs(_f32(tx) - _f32(x)).max() < 1e-5
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference_bf16(arch, impl):
    cfg, tcfg, jp, tp = _params(arch)
    rc, trc = _rcs(seq_len=64, global_batch=2, kind="prefill",
                   attn_impl=impl, remat="none")
    toks = _tokens(cfg, 2, 64, 2)
    x, *_ = JR.forward(cfg, jp, {"tokens": jnp.asarray(toks)}, rc)
    want = _f32(JR.unembed(cfg, jp, x, rc))
    tx, *_ = TR.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)}, trc)
    got = TR.unembed(tcfg, tp, tx, trc)
    assert got.dtype == torch.bfloat16
    assert np.abs(_f32(got) - want).max() < BF16_REL * np.abs(want).max()


def test_flash_path_is_taken_only_with_a_static_window(monkeypatch):
    """qwen3 (one window for all layers) launches the flash entry once per
    layer; gemma3 (5 local : 1 global) takes the plain path, as the
    reference does with a per-layer window."""
    calls = []
    real = port_fa.flash_attention

    def counted(*a, **kw):
        calls.append(kw.get("window"))
        return real(*a, **kw)
    monkeypatch.setattr(port_fa, "flash_attention", counted)
    for arch, want in (("qwen3-4b", [0, 0]), ("gemma3-12b", [])):
        _, tcfg, _, tp = _params(arch)
        _, trc = _rcs(seq_len=32, global_batch=1, kind="prefill",
                      attn_impl="flash")
        calls.clear()
        TR.forward(tcfg, tp, {"tokens": torch.zeros((1, 32), dtype=torch.long)},
                   trc)
        assert calls == want, arch


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-7b"])
def test_prefill_step_matches_reference_forward(arch):
    cfg, tcfg, jp, tp = _params(arch)
    rc, trc = _rcs(seq_len=32, global_batch=2, kind="prefill",
                   attn_impl="flash", compute_dtype="float32")
    toks = _tokens(cfg, 2, 32, 3)
    x, _, cache, _, _ = JR.forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                                   rc, return_cache=True)
    logits = JR.unembed(cfg, jp, x[:, -1:], rc)
    want_tok = np.asarray(jnp.argmax(logits, axis=-1).astype(jnp.int32))
    step = tsteps.build_prefill_step(tcfg, trc, device="cpu")
    tok, tcache = step(tp, {"tokens": toks})
    assert tok.dtype == torch.int32 and tuple(tok.shape) == (2, 1)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    assert set(tcache) == set(cache) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(tcache[name].shape) == cache[name].shape
        assert np.abs(_f32(tcache[name]) - _f32(cache[name])).max() < 1e-5


def _zeros_cache(spec):
    return jax.tree.map(lambda s: jnp.zeros(s[0], s[1]), spec,
                        is_leaf=lambda x: isinstance(x, tuple)
                        and isinstance(x[0], tuple))


def test_decode_matches_forward_incrementally():
    """Prefill-forward logits at position t == decoding tokens one by one
    (twin of the reference's test), and each decode step equals the
    reference's."""
    cfg, tcfg, jp, tp = _params("qwen3-4b")
    rc, trc = _rcs(seq_len=16, global_batch=2, kind="train",
                   attn_impl="ref", compute_dtype="float32",
                   param_dtype="float32", remat="none")
    toks = _tokens(cfg, 2, 8, 7)
    tx, *_ = TR.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)}, trc)
    full_logits = _f32(TR.unembed(tcfg, tp, tx, trc))
    spec = TR.init_cache(tcfg, 2, 16, torch.float32)
    cache = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in spec.items()}
    jcache = _zeros_cache(JR.init_cache(cfg, 2, 16, jnp.float32))
    serve = tsteps.build_serve_step(tcfg, trc, device="cpu")
    errs = []
    for t in range(8):
        tok = toks[:, t:t + 1]
        with torch.no_grad():
            lg, cache = TR.decode(tcfg, tp, cache, torch.from_numpy(tok), t,
                                  trc)
        jlg, jcache = JR.decode(cfg, jp, jcache, jnp.asarray(tok),
                                jnp.asarray(t, jnp.int32), rc)
        assert np.abs(_f32(lg) - _f32(jlg)).max() < 1e-5
        errs.append(np.abs(_f32(lg[:, 0]) - full_logits[:, t]).max())
    assert max(errs) < 1e-3, errs
    for name in ("k", "v"):
        assert np.abs(_f32(cache[name]) - _f32(jcache[name])).max() < 1e-5
    # the serve step is decode + argmax
    nxt, _ = serve(tp, cache, toks[:, :1], 8)
    np.testing.assert_array_equal(
        nxt.numpy(), np.argmax(_f32(TR.decode(
            tcfg, tp, cache, torch.from_numpy(toks[:, :1]), 8, trc)[0]), -1))


def _requests(mod):
    return [mod.Request(1, [5, 6, 7], max_new=6), mod.Request(2, [9], max_new=4),
            mod.Request(3, [11, 3, 200, 17, 42], max_new=5)]


def test_server_matches_reference_token_for_token_f32():
    cfg, tcfg, jp, tp = _params("qwen3-4b")
    ref_srv = jserve.BatchedServer(cfg, jp, max_seq=32)
    ref_srv.rc = dataclasses.replace(ref_srv.rc, compute_dtype="float32")
    srv = tserve.BatchedServer(tcfg, tp, max_seq=32, device="cpu")
    srv.rc = dataclasses.replace(srv.rc, compute_dtype="float32")
    want = ref_srv.generate(_requests(jserve))
    got = srv.generate(_requests(tserve))
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == [6, 4, 5]
    assert all(r.done for r in got)


def test_server_first_step_logits_match_reference_bf16():
    cfg, tcfg, jp, tp = _params("qwen3-4b")
    ref_srv = jserve.BatchedServer(cfg, jp, max_seq=32)
    srv = tserve.BatchedServer(tcfg, tp, max_seq=32, device="cpu")
    assert srv.rc == port_config.RunConfig(**dataclasses.asdict(ref_srv.rc))
    tok = np.array([[5], [9]], np.int32)
    want, _ = ref_srv._decode(jp, ref_srv._fresh_cache(2), jnp.asarray(tok),
                              jnp.asarray(0, jnp.int32))
    got, cache = srv._decode(srv._fresh_cache(2), tok, 0)
    assert cache["k"].dtype == torch.bfloat16
    want = _f32(want)
    assert np.abs(_f32(got) - want).max() < BF16_REL * np.abs(want).max()


def test_server_stops_at_eos_and_max_seq():
    cfg, tcfg, jp, tp = _params("yi-9b")
    srv = tserve.BatchedServer(tcfg, tp, max_seq=8, device="cpu")
    out = srv.generate([tserve.Request(1, [1, 2, 3, 4, 5], max_new=10)])
    # positions 5 and 6 are decoded; the step at max_seq - 1 is not taken
    assert len(out[0].out) == 3 and out[0].done
    first = out[0].out[0]
    srv = tserve.BatchedServer(tcfg, tp, max_seq=32, eos=first, device="cpu")
    out = srv.generate([tserve.Request(1, [1, 2, 3, 4, 5], max_new=10)])
    assert out[0].out == [first]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.models.registry import count_params
    from repro_torch.configs import get_config
    cfg, want = get_config(arch), ref_config(arch)
    if cfg.family != "transformer":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TR.count_params(cfg)
        return
    assert cfg.n_params == TR.count_params(cfg) == count_params(want)
    assert cfg.n_active_params == count_params(want, active_only=True)


def test_qwen3_4b_full_width_parameter_count():
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-4b")
    total = sum(int(np.prod(d.shape)) for _, d in
                TL.tree_items(TR.param_defs(cfg)))
    assert total == 4_411_424_256        # 17.6 GB in float32
    assert cfg.n_params == total - 151936 * 2560


@pytest.mark.parametrize("arch", ["phi3.5-moe", "whisper-tiny",
                                  "paligemma-3b", "rwkv6-3b", "zamba2-7b"])
def test_unported_models_raise(arch):
    tcfg = port_smoke(arch)
    _, trc = _rcs(seq_len=8, global_batch=1, kind="prefill")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        defs = TR.param_defs(tcfg)
        params = TL.tree_init(defs, torch.Generator().manual_seed(0))
        TR.forward(tcfg, params, {"tokens": torch.zeros((1, 8),
                                                        dtype=torch.long)},
                   trc)


def test_windowed_cache_raises():
    tcfg = port_smoke("gemma3-12b")
    with pytest.raises(NotImplementedError, match="decode_windowed"):
        TR.init_cache(tcfg, 1, 16, torch.float32, windowed=True)


def test_tree_init_shapes_and_statistics():
    tcfg = port_smoke("qwen2-7b")
    defs = TR.param_defs(tcfg)
    a = TL.tree_init(defs, torch.Generator().manual_seed(5))
    b = TL.tree_init(defs, torch.Generator().manual_seed(5))
    for (path, d), (_, t), (_, u) in zip(TL.tree_items(defs),
                                        TL.tree_items(a), TL.tree_items(b)):
        assert tuple(t.shape) == d.shape and t.dtype == torch.float32
        assert torch.equal(t, u), path                 # seeded
        if d.init == "zeros":
            assert not t.any(), path
    emb = a["embed"]                       # std sqrt(d) / sqrt(fan_in = V)
    want = np.sqrt(tcfg.d_model) / np.sqrt(tcfg.vocab)
    assert abs(float(emb.std()) - want) < 0.05 * want
    half = TL.tree_init(defs, torch.Generator().manual_seed(5),
                        dtype=torch.bfloat16)
    assert half["layers"]["attn"]["wq"].dtype == torch.bfloat16


def test_bridge_round_trip():
    cfg, tcfg, jp, tp = _params("gemma3-12b")
    back = convert.to_numpy(tp)
    for (path, want), (_, got) in zip(
            TL.tree_items(jax.tree.map(np.asarray, jp)),
            TL.tree_items(back)):
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    half = convert.from_numpy(back, device="cpu", dtype=torch.bfloat16)
    assert convert.to_numpy(half)["embed"].dtype == np.float32


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    tcfg = port_smoke("qwen3-4b")
    _, trc = _rcs(seq_len=8, global_batch=1, kind="prefill")
    with pytest.raises(RuntimeError, match="cuda"):
        tsteps.build_prefill_step(tcfg, trc)            # "cuda" by default
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.BatchedServer(tcfg, {})
    with pytest.raises(RuntimeError, match="cuda"):
        convert.from_numpy({"a": np.zeros(2)})


def test_step_refuses_parameters_on_another_device():
    _, tcfg, _, tp = _params("qwen3-4b")
    _, trc = _rcs(seq_len=8, global_batch=1, kind="prefill")
    step = tsteps.build_prefill_step(tcfg, trc, device="cpu")
    meta = TL.tree_map(lambda t: t.to("meta"), tp)
    with pytest.raises(ValueError, match="lie on meta"):
        step(meta, {"tokens": np.zeros((1, 8), np.int32)})
