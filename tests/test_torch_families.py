"""The port's encoder-decoder (whisper), patch-prefix (paligemma) and
ring-buffered windowed decode (gemma3) against the JAX reference, and
BatchedServer on these families.

Parameters come from the reference's `tree_init` through the numpy
bridge; tokens, frames and patches are made with numpy from a seed.
Tolerances: f32 compute within 1e-5 (the two sum in other orders); bf16
compute within 3 % of the largest logit (the two frameworks round to
bf16 at other places), as test_torch_models.py holds the dense models.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import RunConfig  # noqa: E402
from repro.train import serve as jserve  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as port_fa  # noqa: E402
from repro_torch.models import config as port_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.train import serve as tserve  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

BF16_REL = 3e-2


def _params(arch, seed=0):
    cfg = get_smoke_config(arch)
    jp = JL.tree_init(JR.param_defs(cfg), jax.random.PRNGKey(seed))
    return cfg, port_smoke(arch), jp, convert.from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")


def _rcs(**kw):
    return RunConfig(**kw), port_config.RunConfig(**kw)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if cfg.enc_layers:
        b["frames"] = rng.standard_normal((B, cfg.enc_frames, cfg.d_model),
                                          dtype=np.float32)
    if cfg.n_patches:
        b["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model),
                                           dtype=np.float32)
    return b


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("impl", ["ref", "chunked", "flash"])
@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b"])
def test_forward_and_cache_match_reference_f32(arch, impl):
    """B=2 x S=32 (+ 16 frames or 8 patches), f32: hidden states,
    logits, the encoder's output and every cache leaf (K/V over S + P
    positions, whisper's per-layer cross K/V) within 1e-5."""
    cfg, tcfg, jp, tp = _params(arch)
    rc, trc = _rcs(seq_len=32, global_batch=2, kind="prefill",
                   attn_impl=impl, attn_chunk=8, compute_dtype="float32",
                   remat="none")
    jb, tb = _both(_batch(cfg, 2, 32, 1))
    x, plen, cache, enc, _ = JR.forward(cfg, jp, jb, rc, return_cache=True)
    tx, tplen, tcache, tenc, _ = TR.forward(tcfg, tp, tb, trc,
                                            return_cache=True)
    assert tplen == plen == cfg.n_patches
    assert np.abs(_f32(tx) - _f32(x)).max() < 1e-5
    assert np.abs(_f32(TR.unembed(tcfg, tp, tx, trc))
                  - _f32(JR.unembed(cfg, jp, x, rc))).max() < 1e-5
    assert (tenc is None) == (enc is None)
    if enc is not None:
        assert np.abs(_f32(tenc) - _f32(enc)).max() < 1e-5
    assert set(tcache) == set(cache)
    for name in cache:
        assert tuple(tcache[name].shape) == cache[name].shape
        assert np.abs(_f32(tcache[name]) - _f32(cache[name])).max() < 1e-5


@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b"])
def test_forward_matches_reference_bf16(arch):
    cfg, tcfg, jp, tp = _params(arch)
    rc, trc = _rcs(seq_len=32, global_batch=2, kind="prefill",
                   attn_impl="flash", remat="none")
    jb, tb = _both(_batch(cfg, 2, 32, 2))
    x, *_ = JR.forward(cfg, jp, jb, rc)
    tx, *_ = TR.forward(tcfg, tp, tb, trc)
    want = _f32(JR.unembed(cfg, jp, x, rc))
    got = TR.unembed(tcfg, tp, tx, trc)
    assert got.dtype == torch.bfloat16
    assert np.abs(_f32(got) - want).max() < BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("arch,launches", [
    ("whisper-tiny", 2), ("paligemma-3b", 0), ("phi3.5-moe", 2),
    ("dbrx-132b", 2), ("gemma3-12b", 0)])
def test_flash_is_taken_where_the_reference_takes_it(arch, launches,
                                                     monkeypatch):
    """attn_impl="flash": the decoder of whisper and the MoE models take
    the kernel once a layer; the whisper encoder and cross attention,
    paligemma's prefix and gemma3's local:global mix never do."""
    calls = []
    real = port_fa.flash_attention
    monkeypatch.setattr(port_fa, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or
                        real(*a, **kw))
    cfg, tcfg, _, tp = _params(arch)
    _, trc = _rcs(seq_len=16, global_batch=1, kind="prefill",
                  attn_impl="flash")
    _, tb = _both(_batch(cfg, 1, 16, 3))
    TR.forward(tcfg, tp, tb, trc)
    assert len(calls) == launches
    assert all(s[2] == 16 for s in calls)        # decoder length only


@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b",
                                  "phi3.5-moe", "dbrx-132b"])
def test_prefill_step_matches_reference(arch):
    """build_prefill_step, f32: the next tokens equal the reference's
    and the cache holds the reference's leaves, within 1e-5."""
    cfg, tcfg, jp, tp = _params(arch)
    rc, trc = _rcs(seq_len=16, global_batch=2, kind="prefill",
                   attn_impl="ref", compute_dtype="float32")
    b = _batch(cfg, 2, 16, 4)
    jb, _ = _both(b)
    x, _, cache, _, _ = JR.forward(cfg, jp, jb, rc, return_cache=True)
    want = np.asarray(jnp.argmax(JR.unembed(cfg, jp, x[:, -1:], rc), -1))
    tok, tcache = tsteps.build_prefill_step(tcfg, trc, device="cpu")(tp, b)
    np.testing.assert_array_equal(tok.numpy(), want)
    assert set(tcache) == set(cache)
    for name in cache:
        assert np.abs(_f32(tcache[name]) - _f32(cache[name])).max() < 1e-5


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b",
                                  "gemma3-12b", "rwkv6-3b", "zamba2-7b"])
def test_decode_cache_has_the_reference_shapes(arch, windowed):
    """steps.decode_cache against the reference's decode_cache_structs
    (seq_len + n_patches positions, ring buffers with windowed_cache)."""
    cfg, tcfg = get_smoke_config(arch), port_smoke(arch)
    rc, trc = _rcs(seq_len=24, global_batch=2, kind="decode",
                   windowed_cache=windowed)
    want = jsteps.decode_cache_structs(cfg, rc)
    got = tsteps.decode_cache(tcfg, trc, device="cpu")
    assert set(got) == set(want)
    for name, s in want.items():
        assert tuple(got[name].shape) == s.shape, name
        assert got[name].dtype == getattr(torch, s.dtype.name), name
        assert not got[name].any()
    assert ("k_loc" in got) == (windowed and arch == "gemma3-12b")


def test_batch_shapes_match_reference():
    for arch in ("whisper-tiny", "paligemma-3b", "qwen3-4b"):
        cfg, tcfg = get_smoke_config(arch), port_smoke(arch)
        for nmb in (1, 2):
            rc, trc = _rcs(seq_len=8, global_batch=4, kind="train",
                           num_microbatches=nmb)
            want = jsteps.batch_structs(cfg, rc, with_labels=True)
            got = tsteps.batch_shapes(tcfg, trc, with_labels=True)
            assert {k: v[0] for k, v in got.items()} == {
                k: v.shape for k, v in want.items()}
            b = tsteps.make_batch(tcfg, trc, torch.Generator().manual_seed(0))
            for k, (shape, dt) in got.items():
                assert tuple(b[k].shape) == shape and b[k].dtype == dt
            assert int(b["tokens"].max()) < tcfg.vocab


# --------------------------------------------- the ring-buffered decode

def test_windowed_decode_matches_reference_past_the_window():
    """gemma3 smoke (one 5:1 group, window 8), f32, 20 decode steps from
    a zero cache: each step's logits against the reference's
    decode_windowed within 1e-5, and against the port's full-cache decode
    within 1e-5 (past the window the ring holds only the last 8 keys,
    which is all a local layer sees); the ring caches equal the
    reference's."""
    cfg, tcfg, jp, tp = _params("gemma3-12b")
    rc, trc = _rcs(seq_len=32, global_batch=2, kind="decode",
                   attn_impl="ref", compute_dtype="float32")
    spec = JR.init_cache(cfg, 2, 32, jnp.float32, windowed=True)
    tspec = TR.init_cache(tcfg, 2, 32, torch.float32, windowed=True)
    assert {k: v[0] for k, v in tspec.items()} == {
        k: v[0] for k, v in spec.items()}
    assert tspec["k_loc"][0][3] == cfg.sliding_window == 8
    jcache = jax.tree.map(lambda s: jnp.zeros(s[0], s[1]), spec,
                          is_leaf=lambda x: isinstance(x, tuple)
                          and isinstance(x[0], tuple))
    ring = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in tspec.items()}
    full = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in
            TR.init_cache(tcfg, 2, 32, torch.float32).items()}
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 20),
                                             dtype=np.int32)
    for t in range(20):
        tok = toks[:, t:t + 1]
        jlg, jcache = JT.decode_windowed(cfg, jp, jcache, jnp.asarray(tok),
                                         jnp.asarray(t, jnp.int32), rc)
        with torch.no_grad():
            lg, ring = TR.decode(tcfg, tp, ring, torch.from_numpy(tok), t,
                                 trc)
            flg, full = TR.decode(tcfg, tp, full, torch.from_numpy(tok), t,
                                  trc)
        assert np.abs(_f32(lg) - _f32(jlg)).max() < 1e-5, t
        assert np.abs(_f32(lg) - _f32(flg)).max() < 1e-5, t
    for name in spec:
        assert np.abs(_f32(ring[name]) - _f32(jcache[name])).max() < 1e-5


def test_ring_slot_holds_the_last_positions():
    """After 11 steps on a ring of 8 slots, slot s holds position
    10 - ((10 - s) mod 8): the keys of positions 8, 9, 10 overwrite
    slots 0, 1, 2."""
    _, tcfg, _, tp = _params("gemma3-12b")
    _, trc = _rcs(seq_len=32, global_batch=1, kind="decode",
                  attn_impl="ref", compute_dtype="float32")
    ring = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in
            TR.init_cache(tcfg, 1, 32, torch.float32, windowed=True).items()}
    full = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in
            TR.init_cache(tcfg, 1, 32, torch.float32).items()}
    with torch.no_grad():
        for t in range(11):
            tok = torch.full((1, 1), 7 + t)
            TR.decode(tcfg, tp, ring, tok, t, trc)
            TR.decode(tcfg, tp, full, tok, t, trc)
    for s in range(8):
        p = 10 - (10 - s) % 8
        torch.testing.assert_close(ring["k_loc"][0, 0, 0, s],
                                   full["k"][0, 0, p], rtol=0, atol=1e-6)


# ------------------------------------------------------------- serving

def _requests(mod):
    return [mod.Request(1, [5, 6, 7], max_new=6),
            mod.Request(2, [9], max_new=4),
            mod.Request(3, [11, 3, 200, 17, 42], max_new=5)]


@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b",
                                  "phi3.5-moe", "dbrx-132b", "gemma3-12b"])
def test_server_matches_reference_token_for_token_f32(arch):
    """BatchedServer on "cpu", f32 compute: the same tokens as the
    reference's server (whisper decodes against the zero cross cache,
    paligemma without patches, as the reference's server does)."""
    cfg, tcfg, jp, tp = _params(arch)
    ref_srv = jserve.BatchedServer(cfg, jp, max_seq=32)
    ref_srv.rc = dataclasses.replace(ref_srv.rc, compute_dtype="float32")
    srv = tserve.BatchedServer(tcfg, tp, max_seq=32, device="cpu")
    srv.rc = dataclasses.replace(srv.rc, compute_dtype="float32")
    want = ref_srv.generate(_requests(jserve))
    got = srv.generate(_requests(tserve))
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == [6, 4, 5]


def test_serve_step_takes_the_windowed_cache():
    """build_serve_step on a decode_cache with windowed_cache: the next
    tokens equal the reference's serve step on its windowed cache."""
    cfg, tcfg, jp, tp = _params("gemma3-12b")
    rc, trc = _rcs(seq_len=16, global_batch=2, kind="decode",
                   attn_impl="ref", compute_dtype="float32",
                   windowed_cache=True)
    cache = tsteps.decode_cache(tcfg, trc, device="cpu")
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jsteps.decode_cache_structs(cfg, rc))
    step = tsteps.build_serve_step(tcfg, trc, device="cpu")
    tok = np.array([[3], [4]], np.int32)
    for pos in range(12):
        nxt, cache = step(tp, cache, tok, pos)
        jlg, jcache = JR.decode(cfg, jp, jcache, jnp.asarray(tok),
                                jnp.asarray(pos, jnp.int32), rc)
        np.testing.assert_array_equal(
            nxt.numpy(), np.asarray(jnp.argmax(jlg, -1)))
        tok = nxt.numpy()
