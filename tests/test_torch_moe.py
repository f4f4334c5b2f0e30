"""The port's MoE FFN (`repro_torch.models.moe`) against the reference's
global dispatch (`repro.models.moe._moe_ffn_global`), on the smoke configs
of phi3.5-moe and dbrx.

Inputs are made with numpy from a seed; parameters come from the
reference's `tree_init` through the numpy bridge.  Routing is compared on
router probabilities without exact ties: `jax.lax.top_k` takes the lower
index first on a tie and `torch.topk` promises nothing, so no test is
built on ties.

Tolerances: f32 outputs and aux within 1e-5 (the two sum in other
orders); routing (experts, their order, the dispatch rows and the
dropped assignments) exactly equal; gradients as the dense models'
(test_torch_models.py): each leaf's largest gap within 1e-5 of its
largest entry; bf16 outputs within 3 % of the largest.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models.config import RunConfig  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.models import config as port_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

MOE = ["phi3.5-moe", "dbrx-132b"]


# an expert that overflows: inputs shifted by OVERFLOW[0] and expert 0's
# router column by OVERFLOW[1] raise expert 0's gate by about 3 for every
# token (no probability saturates to an exact 0, so there are no ties)
OVERFLOW = (1.0, 0.05)


def _layer_params(arch, seed=0, overflow=False):
    """Layer 0's MLP parameters of the smoke config, in both packages."""
    cfg = get_smoke_config(arch)
    jp = JL.tree_init(JR.param_defs(cfg), jax.random.PRNGKey(seed))
    mlp = jax.tree.map(lambda a: np.array(a[0]), jp["layers"]["mlp"])
    if overflow:
        mlp["router"][:, 0] += OVERFLOW[1]
    return cfg, port_smoke(arch), mlp, convert.from_numpy(mlp, device="cpu")


def _rcs(**kw):
    return RunConfig(**kw), port_config.RunConfig(**kw)


def _x(T, d, seed, overflow=False):
    x = np.random.default_rng(seed).standard_normal((T, d), dtype=np.float32)
    return x + OVERFLOW[0] if overflow else x


def _reference_routing(cfg, p, x):
    """The reference's routing and dispatch, line by line
    (`_moe_ffn_global`), on numpy inputs: (top_e, dest, keep)."""
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    C = jmoe.capacity(cfg, T)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1)
    _, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.zeros(E, jnp.int32).at[flat_e].add(1)
    starts = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(T * k, dtype=jnp.int32) - starts[sorted_e]
    keep = pos_in_e < C
    dest = jnp.where(keep, sorted_e * C + pos_in_e, E * C)
    return np.asarray(top_e), np.asarray(dest), np.asarray(keep)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("T", [1, 2, 7, 8, 31, 64, 100, 128, 1000, 4096,
                               8192, 8193, 32768])
def test_capacity_matches_reference(arch, T):
    cfg, tcfg, _, _ = _layer_params(arch)
    assert moe.capacity(tcfg, T) == jmoe.capacity(cfg, T)
    full = port_config.ModelConfig(**{
        **tcfg.__dict__, "n_experts": 16, "top_k": cfg.top_k})
    want = jmoe.capacity(cfg.scaled(n_experts=16), T)
    assert moe.capacity(full, T) == want
    assert want % 8 == 0 and want >= 8


def test_capacity_of_the_card_runs():
    """phi3.5-moe's prefill of 2 x 4096 tokens: 1280 slots an expert."""
    from repro_torch.configs import get_config
    assert moe.capacity(get_config("phi3.5-moe"), 8192) == 1280
    assert moe.capacity(get_config("dbrx-132b"), 8192) == 2560


@pytest.mark.parametrize("overflow", [False, True],
                         ids=["balanced", "overflowing"])
@pytest.mark.parametrize("arch", MOE)
def test_routing_dispatch_output_and_aux_match_reference(arch, overflow):
    """T=64 tokens, f32: the experts and their order, the dispatch rows,
    the dropped assignments (some, when one expert overflows), the output
    and aux of the port against `_moe_ffn_global`."""
    cfg, tcfg, p, tp = _layer_params(arch, overflow=overflow)
    rc, trc = _rcs(seq_len=64, global_batch=1, kind="train",
                   compute_dtype="float32")
    x = _x(64, cfg.d_model, 5, overflow)
    top_e, dest, keep = _reference_routing(cfg, p, x)
    tx = torch.from_numpy(x)
    _, t_top_e, _ = moe.route(tcfg, tp, tx)
    order, t_dest, t_keep = moe.dispatch(tcfg, t_top_e,
                                         moe.capacity(tcfg, 64))
    np.testing.assert_array_equal(t_top_e.numpy(), top_e)
    np.testing.assert_array_equal(t_dest.numpy(), dest)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    assert bool((~keep).any()) == overflow
    y, aux = jmoe._moe_ffn_global(cfg, jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), rc)
    ty, taux = moe.moe_ffn(tcfg, tp, tx, trc)
    assert np.abs(ty.numpy() - np.asarray(y)).max() < 1e-5
    assert abs(float(taux) - float(aux)) < 1e-5


@pytest.mark.parametrize("arch", MOE)
def test_gradient_through_dropped_tokens_matches_reference(arch):
    """With an overflowing expert: the gradient of a weighted sum of the
    output with respect to x and every parameter equals the reference's
    (jax.grad); the drop slot passes no gradient."""
    cfg, tcfg, p, tp = _layer_params(arch, overflow=True)
    rc, trc = _rcs(seq_len=64, global_batch=1, kind="train",
                   compute_dtype="float32")
    x = _x(64, cfg.d_model, 6, overflow=True)
    assert not _reference_routing(cfg, p, x)[2].all()
    c = np.random.default_rng(7).standard_normal((64, cfg.d_model),
                                                 dtype=np.float32)

    def jloss(p, x):
        y, aux = jmoe._moe_ffn_global(cfg, p, x, rc)
        return jnp.sum(y * c) + aux

    want = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                           jnp.asarray(x))
    tp = TL.tree_map(lambda t: t.requires_grad_(), tp)
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_ffn(tcfg, tp, tx, trc)
    (torch.sum(y * torch.from_numpy(c)) + aux).backward()
    gx = np.asarray(want[1])
    assert np.abs(tx.grad.numpy() - gx).max() <= 1e-5 * np.abs(gx).max()
    for (path, t), (_, w) in zip(TL.tree_items(tp),
                                 TL.tree_items(jax.tree.map(np.asarray,
                                                            want[0]))):
        if t.grad is None:              # the norm's scale: not used here
            assert path == ("ln",) and not w.any()
            continue
        gap = np.abs(t.grad.numpy() - w).max() / np.abs(w).max()
        assert gap < 1e-5, (path, gap)


@pytest.mark.parametrize("arch", MOE)
def test_output_is_the_same_bits_on_repeat(arch):
    """The combine has no scatter-add: two runs, and their gradients,
    are equal bit for bit."""
    _, tcfg, _, tp = _layer_params(arch, overflow=True)
    _, trc = _rcs(seq_len=64, global_batch=1, kind="train",
                  compute_dtype="float32")
    outs = []
    for _ in range(2):
        tx = torch.from_numpy(_x(64, tcfg.d_model, 8, overflow=True)
                              ).requires_grad_()
        y, aux = moe.moe_ffn(tcfg, tp, tx, trc)
        (y.square().sum() + aux).backward()
        outs.append((y.detach(), tx.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("arch", MOE)
def test_bf16_output_matches_reference(arch):
    """bf16 compute, on inputs whose routing agrees (the router runs in
    f32 in both): within 3 % of the largest output."""
    cfg, tcfg, p, tp = _layer_params(arch)
    rc, trc = _rcs(seq_len=64, global_batch=1, kind="train")
    x = _x(64, cfg.d_model, 9)
    y, _ = jmoe._moe_ffn_global(cfg, jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x).astype(jnp.bfloat16), rc)
    ty, _ = moe.moe_ffn(tcfg, tp, torch.from_numpy(x).to(torch.bfloat16),
                        trc)
    assert ty.dtype == torch.bfloat16
    want = np.asarray(y.astype(jnp.float32))
    assert np.abs(ty.float().numpy() - want).max() < 3e-2 * np.abs(
        want).max()


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_gradients_match_reference_f32(arch, remat):
    """The whole model: loss (with 0.01 aux) and every gradient leaf of
    the port (`steps._value_and_grad`) against `jax.value_and_grad` of
    the reference `loss_fn`, f32, B=2 x S=32: loss within 1e-6 relative,
    each leaf's largest gap within 1e-5 of its largest entry."""
    cfg = get_smoke_config(arch)
    jp = JL.tree_init(JR.param_defs(cfg), jax.random.PRNGKey(1))
    tp = convert.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rc, trc = _rcs(seq_len=32, global_batch=2, kind="train",
                   attn_impl="ref", compute_dtype="float32", remat=remat)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab, (2, 32), dtype=np.int32)
    labels = np.roll(toks, -1, axis=-1)
    loss, grads = jax.value_and_grad(functools.partial(
        jsteps.loss_fn, cfg, rc=rc))(jp, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)})
    tloss, tgrads = tsteps._value_and_grad(port_smoke(arch), trc, tp, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert float(tloss) == pytest.approx(float(loss), rel=1e-6)
    for (path, g), (wpath, w) in zip(
            TL.tree_items(tgrads),
            TL.tree_items(jax.tree.map(np.asarray, grads)), strict=True):
        assert path == wpath
        gap = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert gap < 1e-5, (".".join(path), gap)


def test_flash_prefill_of_moe_matches_reference():
    """phi3.5-moe smoke through both prefill steps with attn_impl="flash"
    (the reference's Pallas kernel in interpret mode, the port's plain
    version on the CPU), f32: the next tokens equal, the K/V caches
    within 1e-5."""
    cfg, tcfg = get_smoke_config("phi3.5-moe"), port_smoke("phi3.5-moe")
    jp = JL.tree_init(JR.param_defs(cfg), jax.random.PRNGKey(2))
    tp = convert.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rc, trc = _rcs(seq_len=32, global_batch=2, kind="prefill",
                   attn_impl="flash", compute_dtype="float32")
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (2, 32),
                                              dtype=np.int32)
    x, _, cache, _, _ = JR.forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                                   rc, return_cache=True)
    want = np.asarray(jnp.argmax(JR.unembed(cfg, jp, x[:, -1:], rc), -1))
    tok, tcache = tsteps.build_prefill_step(tcfg, trc, device="cpu")(
        tp, {"tokens": toks})
    np.testing.assert_array_equal(tok.numpy(), want)
    for name in ("k", "v"):
        assert np.abs(tcache[name].numpy() - np.asarray(cache[name])).max() \
            < 1e-5
