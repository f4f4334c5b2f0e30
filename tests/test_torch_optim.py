"""The port's hand-written AdamW against `repro.optim.adamw`.

The same random trees (numpy, from a seed) go through both packages:
f32 parameters, gradients and moments keyed like a model's parameters.
Tolerance: 1e-6 relative to each leaf's largest value (the two
frameworks may round a product or a sum differently, by an ulp).  The
port updates parameters and moments in place; the step counter is an
int32 scalar in both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.models.layers import tree_items  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

REL = 1e-6
SHAPES = {"embed": (64, 16), "final_ln": (16,),
          "layers": {"attn": {"wq": (2, 16, 32), "ln": (2, 16)},
                     "mlp": {"wd": (2, 32, 16)}}}


def _tree(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return make(shapes)


def _port(tree):
    return {k: _port(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else torch.from_numpy(np.array(tree))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want):
    """Every leaf of the port's tree `got` within REL of `want`'s."""
    for path, g in tree_items(got):
        w = want
        for key in path:
            w = w[key]
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=REL * max(1e-30, np.abs(w).max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("gscale", [0.01, 10.0])       # below / above clip
def test_apply_updates_matches_reference(steps, gscale):
    cfg_kw = dict(lr=1e-2, warmup_steps=2, weight_decay=0.1, grad_clip=1.0)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    p0 = _tree(0)
    jp, tp = _jax(p0), _port(p0)
    jst, tst = jadamw.init_state(jp), adamw.init_state(tp)
    for s in range(steps):
        g = _tree(100 + s, gscale)
        jp, jst, jn = jadamw.apply_updates(jcfg, jp, _jax(g), jst)
        tp, tst, tn = adamw.apply_updates(tcfg, tp, _port(g), tst)
        assert float(tn) == pytest.approx(float(jn), rel=REL)
    _close(tp, jp)
    _close(tst["m"], jst["m"])
    _close(tst["v"], jst["v"])
    assert tst["step"].dtype == torch.int32 and tst["step"].dim() == 0
    assert int(tst["step"]) == int(jst["step"]) == steps


def test_apply_updates_reads_grads_and_writes_in_place():
    tp = _port(_tree(0))
    st = adamw.init_state(tp)
    g = _port(_tree(1, 5.0))
    g_before = {p: t.clone() for p, t in tree_items(g)}
    emb = tp["embed"]
    new_p, new_st, _ = adamw.apply_updates(adamw.AdamWConfig(), tp, g, st)
    assert new_p["embed"] is emb and new_st["m"] is st["m"]
    assert all(torch.equal(t, g_before[p]) for p, t in tree_items(g))


@pytest.mark.parametrize("step", [0, 5, 99, 100, 1000])
def test_schedule_warms_up_on_the_step_before_increment(step):
    jcfg, tcfg = jadamw.AdamWConfig(), adamw.AdamWConfig()
    want = float(jadamw._schedule(jcfg, jnp.asarray(step, jnp.int32)))
    got = adamw._schedule(tcfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and float(got) == want


@pytest.mark.parametrize("scale", [0.01, 1.0, 100.0])
def test_clip_by_global_norm_matches_reference(scale):
    g = _tree(7, scale)
    jg, jn = jadamw.clip_by_global_norm(_jax(g), 1.0)
    tg, tn = adamw.clip_by_global_norm(_port(g), 1.0)
    assert float(tn) == pytest.approx(float(jn), rel=REL)
    assert float(adamw.global_norm(_port(g))) == pytest.approx(
        float(jadamw.global_norm(_jax(g))), rel=REL)
    _close(tg, jg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_int8_matches_reference(seed):
    g = (np.random.default_rng(seed).standard_normal((33, 65)) * 3
         ).astype(np.float32)
    jq, js = jadamw.compress_int8(jnp.asarray(g))
    tq, ts = adamw.compress_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == pytest.approx(float(js), rel=REL)
    np.testing.assert_allclose(
        adamw.decompress_int8(tq, ts).numpy(),
        np.asarray(jadamw.decompress_int8(jq, js)), rtol=REL, atol=0)
