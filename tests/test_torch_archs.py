"""Twins of tests/test_archs.py for every architecture in ARCHS, against
the JAX reference: forward and loss, one train step, one decode step,
decode continuing a prefill, and the numpy bridge of each family's
parameter tree.

Parameters come from `repro.models.layers.tree_init` and cross to the
port through the numpy bridge (`repro_torch.models.convert`); tokens,
frames and patches are made with numpy from a seed.  Each test states
its tolerance.
"""
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
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.models import config as port_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

BF16_REL = 3e-2


def _params(arch, seed=0):
    cfg = get_smoke_config(arch)
    jp = JL.tree_init(JR.param_defs(cfg), jax.random.PRNGKey(seed))
    return cfg, port_smoke(arch), jp, convert.from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")


def _rcs(**kw):
    """The same RunConfig in both packages."""
    return RunConfig(**kw), port_config.RunConfig(**kw)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _zeros_cache(spec):
    return jax.tree.map(lambda s: jnp.zeros(s[0], s[1]), spec,
                        is_leaf=lambda x: isinstance(x, tuple)
                        and isinstance(x[0], tuple))


def _batch(cfg, B, S, seed, labels=False):
    """tokens (and next-token labels), plus the config's frames or
    patches, made with numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if labels:
        b["labels"] = np.roll(b["tokens"], -1, axis=-1)
        b["labels"][:, -1] = 0
    if cfg.enc_layers:
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model), dtype=np.float32)
    if cfg.n_patches:
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), dtype=np.float32)
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _no_drop(arch):
    """Smoke configs of both packages; MoE with a capacity factor of
    E / top_k, so that C >= T and no token is dropped: a decode step
    routes B tokens and never drops, so only then can a chain of decode
    steps equal a forward over the whole sequence."""
    cfg, tcfg = get_smoke_config(arch), port_smoke(arch)
    if cfg.is_moe:
        cf = cfg.n_experts / cfg.top_k
        cfg, tcfg = cfg.scaled(capacity_factor=cf), tcfg.scaled(
            capacity_factor=cf)
    return cfg, tcfg


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_loss_match_reference(arch):
    """f32, B=2 x S=16 (+ frames or patches): the final hidden states,
    the logits and aux within 1e-5, the loss (with 0.01 aux for MoE)
    within 1e-6 relative."""
    cfg, tcfg, jp, tp = _params(arch)
    rc, trc = _rcs(seq_len=16, global_batch=2, kind="train",
                   attn_impl="ref", compute_dtype="float32")
    b = _batch(cfg, 2, 16, 21, labels=True)
    x, plen, _, _, aux = JR.forward(cfg, jp, _jb(b), rc)
    tx, tplen, _, _, taux = TR.forward(tcfg, tp, _tb(b), trc)
    assert tplen == plen == cfg.n_patches
    assert tuple(tx.shape) == x.shape == (2, 16 + plen, cfg.d_model)
    assert np.abs(_f32(tx) - _f32(x)).max() < 1e-5
    assert abs(float(taux) - float(aux)) < 1e-5
    got = _f32(TR.unembed(tcfg, tp, tx, trc))
    assert np.abs(got - _f32(JR.unembed(cfg, jp, x, rc))).max() < 1e-5
    loss = jsteps.loss_fn(cfg, jp, _jb(b), rc)
    tloss = tsteps.loss_fn(tcfg, tp, _tb(b), trc)
    assert np.isfinite(float(tloss))
    assert float(tloss) == pytest.approx(float(loss), rel=1e-6)


@pytest.fixture
def auto_mesh():
    """A (1, 1) mesh of Auto axes for the reference's step bundles (the
    default mesh fails on the installed JAX, ROADMAP R1)."""
    from jax.sharding import AxisType
    from repro.parallel import shardings as ref_shardings
    yield jax.make_mesh((1, 1), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2)
    ref_shardings.set_ambient_mesh(None)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step_matches_reference(arch, auto_mesh):
    """One AdamW step from one state, f32, B=2 x S=16: loss within 1e-6
    and grad_norm within 1e-5 relative, the step counter advanced, and
    each leaf's update (new - old) within 1e-3 of the reference's update,
    in norm (the first Adam update is about g / |g|, so entries whose
    gradient is near 0 are where the two packages part)."""
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw as tadamw
    cfg, tcfg, jp, tp = _params(arch)
    rc, trc = _rcs(seq_len=16, global_batch=2, kind="train",
                   attn_impl="ref", compute_dtype="float32")
    b = _batch(cfg, 2, 16, 22, labels=True)
    init = jax.tree.map(np.array, jp)
    bundle = jsteps.build_train_step(cfg, rc, auto_mesh)
    p2, o2, m = bundle.fn(jp, jadamw.init_state(jp), _jb(b))
    step = tsteps.build_train_step(tcfg, trc, device="cpu")
    tp2, to2, tm = step(tp, tadamw.init_state(tp), _tb(b))
    assert int(to2["step"]) == int(o2["step"]) == 1
    assert float(tm["loss"]) == pytest.approx(float(m["loss"]), rel=1e-6)
    assert float(tm["grad_norm"]) == pytest.approx(float(m["grad_norm"]),
                                                   rel=1e-5)
    for (path, i), (_, w), (_, h) in zip(
            TL.tree_items(init), TL.tree_items(jax.tree.map(np.asarray, p2)),
            TL.tree_items(convert.to_numpy(tp2)), strict=True):
        moved = np.linalg.norm((w.astype(np.float64) - i).ravel())
        gap = np.linalg.norm((h.astype(np.float64) - w).ravel())
        assert gap <= 1e-3 * moved, (".".join(path), gap, moved)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_step_matches_reference(arch):
    """One decode step at position 3 on a zero cache (bf16 compute, as
    tests/test_archs.py runs it): finite logits of shape (2, 1, V) within
    3 % of the largest, a cache that was written, and every cache leaf
    of the reference's shape and dtype."""
    cfg, tcfg, jp, tp = _params(arch)
    rc, trc = _rcs(seq_len=64, global_batch=2, kind="decode",
                   attn_impl="ref", param_dtype="float32")
    spec = JR.init_cache(cfg, 2, 64, jnp.bfloat16)
    tspec = TR.init_cache(tcfg, 2, 64, torch.bfloat16)
    assert set(tspec) == set(spec)
    for name, (shape, dt) in spec.items():
        assert tspec[name][0] == shape
        assert tspec[name][1] == getattr(torch, jnp.dtype(dt).name), name
    tok = np.ones((2, 1), np.int32)
    want, _ = JR.decode(cfg, jp, _zeros_cache(spec), jnp.asarray(tok),
                        jnp.asarray(3, jnp.int32), rc)
    cache = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in tspec.items()}
    with torch.no_grad():
        got, cache = TR.decode(tcfg, tp, cache, torch.from_numpy(tok), 3,
                               trc)
    assert tuple(got.shape) == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(got.float()).all())
    assert any(bool(t.any()) for t in cache.values())
    want = _f32(want)
    assert np.abs(_f32(got) - want).max() < BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_the_prefill_f32(arch):
    """f32: a forward over 8 tokens (+ frames or patches) gives the
    logits of each position; decoding the last tokens one by one from
    the cache of a prefill of the first ones (none for the decoder-only
    transformers: they decode from position 0 on a zero cache) gives the
    same logits within 1e-3 (tests/test_archs.py's limit: the chunked
    SSD and the per-step recurrences sum in other orders), and each step
    equals the reference's decode step on the reference's own prefill
    cache within 1e-5."""
    cfg, tcfg = _no_drop(arch)
    jp = JL.tree_init(JR.param_defs(cfg), jax.random.PRNGKey(0))
    tp = convert.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rc, trc = _rcs(seq_len=16, global_batch=2, kind="decode",
                   attn_impl="ref", compute_dtype="float32", remat="none")
    b = _batch(cfg, 2, 8, 23)
    P = cfg.n_patches
    S0 = 0 if cfg.family == "transformer" and not (P or cfg.enc_layers) \
        else 3
    with torch.no_grad():
        tx, *_ = TR.forward(tcfg, tp, _tb(b), trc)
    full = _f32(TR.unembed(tcfg, tp, tx, trc))
    Smax = 16 + P
    spec = JR.init_cache(cfg, 2, Smax, jnp.float32)
    tspec = TR.init_cache(tcfg, 2, Smax, torch.float32)
    jcache, cache = _zeros_cache(spec), {
        k: torch.zeros(s, dtype=dt) for k, (s, dt) in tspec.items()}
    if S0:
        pre = {**b, "tokens": b["tokens"][:, :S0]}
        _, _, jpc, _, _ = JR.forward(cfg, jp, _jb(pre), rc,
                                     return_cache=True)
        with torch.no_grad():
            _, _, tpc, _, _ = TR.forward(tcfg, tp, _tb(pre), trc,
                                         return_cache=True)
        for name in cache:
            src = tpc[name]
            idx = tuple(slice(0, n) for n in src.shape)
            cache[name][idx] = src
            jcache[name] = jcache[name].at[idx].set(jpc[name])
    errs = []
    for t in range(S0, 8):
        pos = t + P
        tok = b["tokens"][:, t:t + 1]
        with torch.no_grad():
            lg, cache = TR.decode(tcfg, tp, cache, torch.from_numpy(tok),
                                  pos, trc)
        jlg, jcache = JR.decode(cfg, jp, jcache, jnp.asarray(tok),
                                jnp.asarray(pos, jnp.int32), rc)
        assert np.abs(_f32(lg) - _f32(jlg)).max() < 1e-5, (t, arch)
        errs.append(np.abs(_f32(lg[:, 0]) - full[:, P + t]).max())
    assert max(errs) < 1e-3, errs
    for name in cache:
        assert np.abs(_f32(cache[name]) - _f32(jcache[name])).max() < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_every_family(arch):
    """The numpy bridge carries each family's tree unchanged (MoE expert
    stacks, encoder and cross-attention leaves, patch projection, RWKV
    and Zamba2 blocks): every leaf path, shape and value round-trips, and
    the port's param_defs name the same leaves with the same shapes."""
    cfg, tcfg, jp, tp = _params(arch)
    want = list(TL.tree_items(jax.tree.map(np.asarray, jp)))
    defs = list(TL.tree_items(TR.param_defs(tcfg)))
    assert [p for p, _ in defs] == [p for p, _ in want]
    for (path, d), (_, w), (_, t) in zip(defs, want, TL.tree_items(tp),
                                         strict=True):
        assert d.shape == w.shape == tuple(t.shape), path
    for (path, w), (_, got) in zip(want, TL.tree_items(convert.to_numpy(tp)),
                                   strict=True):
        np.testing.assert_array_equal(got, w, err_msg=str(path))
