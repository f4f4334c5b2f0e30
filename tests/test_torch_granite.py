"""The port's Granite 4.0-H family (`models/granite_hybrid.py`) against the
plain reference (`tests/reference/granite_hybrid.py`) on the CPU, in
float32, at one period of the layer pattern (`configs/granite4_h_small`
SMOKE: 9 Mamba2 layers and attention at layer 5, d = 64, 8 experts top-3
and a shared expert, N = 16, chunk 16), every weight drawn from a seed.

Tolerance 1e-4 (relative Frobenius norm): the two sum the same float32
products in other orders (the chunked SSD against the reference's
position-by-position recurrence, batched experts against one at a
time), which moves results by a few float32 ulps a layer; a dropped
multiplier, a missing shared expert or conv bias moves them by far more
(`test_each_multiplier_changes_the_result`).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from reference import granite_hybrid as ref  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs import granite4_h_small  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import RunConfig  # noqa: E402
from repro_torch.parallel.shardings import constrain  # noqa: E402
from repro_torch.train import steps  # noqa: E402

SMOKE = granite4_h_small.SMOKE
TOL = 1e-4
F32 = dict(param_dtype="float32", compute_dtype="float32", ssm_chunk=16)


def weights(cfg, seed):
    """Every leaf drawn from `seed`: matrices normal with std
    1/sqrt(fan_in) (the embedding std 1), norm weights and biases std 0.1,
    the conv std 0.5, D about 1, and the Mamba2 leaves as Mamba2 draws
    them: exp(a_log) uniform in [1, 16], dt_bias = softplus^-1 of dt,
    log dt uniform in [log 0.001, log 0.1]."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for path, d in L.tree_items(registry.param_defs(cfg)):
        name = path[-1]
        u = torch.rand(d.shape, generator=g)
        n = torch.randn(d.shape, generator=g)
        if name == "a_log":
            t = torch.log(1.0 + 15.0 * u)
        elif name == "dt_bias":
            dt = torch.exp(math.log(1e-3) + (math.log(0.1) - math.log(1e-3))
                           * u)
            t = dt + torch.log(-torch.expm1(-dt))
        elif name == "conv_w":
            t = 0.5 * n
        elif name == "skip_d":
            t = 1.0 + 0.1 * n
        elif name == "embed":
            t = n
        elif d.init == "zeros":
            t = 0.1 * n
        else:
            t = n / math.sqrt(d.shape[-2])
        L.tree_set(out, path, t)
    return out


def rel(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


def program(cfg, params, toks):
    """The port's logits at every position and its prefill cache."""
    rc = RunConfig(seq_len=toks.shape[-1], global_batch=1, kind="prefill",
                   **F32)
    with torch.no_grad():
        x, _, cache, _, _ = registry.forward(cfg, params, {"tokens": toks},
                                             rc, return_cache=True)
        return registry.unembed(cfg, params, x, rc)[0], cache


def tokens(n, seed, vocab=256):
    return torch.randint(0, vocab, (1, n),
                         generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_prefill_logits_and_cache_match_reference(cf):
    """Every position's logits and every cache entry (each Mamba2 layer's
    conv window and SSM state, the attention layer's K and V); at
    capacity factor 0.5 many assignments drop, in the same places."""
    cfg = SMOKE.scaled(capacity_factor=cf)
    params = weights(cfg, 1)
    toks = tokens(48, 2)
    got, cache = program(cfg, params, toks)
    want, wc = ref.forward(params, cfg, toks[0])
    assert got.shape == want.shape == (48, cfg.vocab)
    assert rel(got, want) < TOL
    assert cache["conv"].shape[0] == len(wc["conv"]) == 9
    assert cache["k"].shape[0] == len(wc["k"]) == 1
    for key in ("conv", "state", "k", "v"):
        for i, w in enumerate(wc[key]):
            assert rel(cache[key][i, 0], w) < TOL, (key, i)
    rc = RunConfig(seq_len=48, global_batch=1, kind="prefill", **F32)
    tok, _ = steps.build_prefill_step(cfg, rc, device="cpu")(
        params, {"tokens": toks})
    assert int(tok[0, 0]) == int(got[-1].argmax())


def test_decode_through_the_cache_matches_the_full_forward():
    """8 tokens decoded one by one from a 32-token prefill's cache against
    the reference's forward over all 40.  The capacity factor lets no
    assignment drop: a decode step routes one token, which never drops,
    where the full forward would drop by its 40 tokens' counts."""
    cfg = SMOKE.scaled(capacity_factor=float(SMOKE.n_experts))
    params = weights(cfg, 3)
    toks = tokens(40, 4)
    want, wc = ref.forward(params, cfg, toks[0])
    S = 32
    _, pre = program(cfg, params, toks[:, :S])
    rc = RunConfig(seq_len=40, global_batch=1, kind="decode", **F32)
    cache = steps.decode_cache(cfg, rc, device="cpu")
    cache["conv"].copy_(pre["conv"])
    cache["state"].copy_(pre["state"])
    cache["k"][:, :, :S] = pre["k"]
    cache["v"][:, :, :S] = pre["v"]
    with torch.no_grad():
        for pos in range(S, 40):
            logits, cache = registry.decode(cfg, params, cache,
                                            toks[:, pos:pos + 1], pos, rc)
            assert rel(logits[0, 0], want[pos]) < TOL, pos
    assert rel(cache["k"][0, 0], wc["k"][0]) < TOL


@pytest.mark.parametrize("change", [
    {"embed_mult": 1.0}, {"residual_mult": 1.0}, {"attn_scale": 0.0},
    {"logits_scale": 1.0}, {"d_ff_shared": 0}, {"conv_bias": False}])
def test_each_multiplier_changes_the_result(change):
    """Each multiplier, the shared expert and the conv bias move the
    logits far past the tolerance, and the reference follows the port
    with each of them changed: none is dropped on either side."""
    params = weights(SMOKE, 5)
    toks = tokens(32, 6)
    base, _ = program(SMOKE, params, toks)
    cfg = SMOKE.scaled(**change)
    kept = {p for p, _ in L.tree_items(registry.param_defs(cfg))}
    sub = {}
    for p, t in L.tree_items(params):
        if p in kept:
            L.tree_set(sub, p, t)
    got, _ = program(cfg, sub, toks)
    assert rel(got, base) > 10 * TOL
    assert rel(got, ref.forward(sub, cfg, toks[0])[0]) < TOL


@pytest.mark.parametrize("arch", ["phi3.5-moe", "zamba2-7b"])
def test_other_families_are_bit_identical_at_the_defaults(arch, monkeypatch):
    """At the new fields' defaults a SMOKE forward gives the same bits as
    with every field passed at its default, and as with the residual sum
    and the softmax scale forced to their plain forms (x + y; 1/sqrt(D)):
    nothing of Granite's is applied to another family."""
    cfg = get_smoke_config(arch)
    params = L.tree_init(registry.param_defs(cfg),
                         torch.Generator().manual_seed(7))
    toks = tokens(64, 8)
    explicit = cfg.scaled(layer_types=(), embed_mult=1.0, residual_mult=1.0,
                          attn_scale=0.0, logits_scale=1.0, d_ff_shared=0,
                          conv_bias=False)
    rc = RunConfig(seq_len=64, global_batch=1, kind="prefill",
                   param_dtype="bfloat16", ssm_chunk=16)
    params = L.tree_map(lambda t: t.to(torch.bfloat16), params)

    def run(c):
        with torch.no_grad():
            x, _, cache, _, _ = registry.forward(c, params, {"tokens": toks},
                                                 rc, return_cache=True)
            return registry.unembed(c, params, x, rc), cache

    a, ca = run(cfg)
    b, cb = run(explicit)
    monkeypatch.setattr(tfm, "_residual", lambda c, x, y: constrain(
        x + y, ("batch", None, None)))
    monkeypatch.setattr(tfm, "_scale", lambda c: None)
    p, cp = run(cfg)
    for other, oc in ((b, cb), (p, cp)):
        assert torch.equal(a, other)
        assert ca.keys() == oc.keys()
        assert all(torch.equal(ca[k], oc[k]) for k in ca)


def test_published_widths_and_parameter_counts():
    """The preset's shape as config.json gives it: 36 Mamba2 and 4
    attention layers, 32.2 G parameters, 8.39 G applied to a token
    (experts at top-10, the shared expert, no head: tied embedding)."""
    cfg = granite4_h_small.CONFIG
    assert cfg.layer_types.count("attention") == 4
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    defs = registry.param_defs(cfg)
    total = sum(math.prod(d.shape) for _, d in L.tree_items(defs))
    assert total == 32_207_337_984
    assert registry.count_params(cfg, active_only=True) == 8_392_079_872
