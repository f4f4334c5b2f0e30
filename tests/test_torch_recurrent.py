"""The port's recurrent families, RWKV-6 (`models/rwkv6.py`) and Zamba2
(`models/zamba2.py`), against the JAX reference.

Parameters come from the reference's `tree_init` through the numpy
bridge; tokens and the scans' inputs are made with numpy from a seed.
Tolerances: f32 within 1e-5 (the two sum in other orders), except where a
test says otherwise; gradients as the dense models' (each leaf's largest
gap within 1e-5 of its largest entry), RWKV's within 5e-5 (its time
loop's backward sums over the positions in another order; 1.01e-5 was
seen on att.wg).  bf16 compute: Zamba2 within 3 % of the largest logit,
as the dense models; RWKV within twice the reference's own bf16 error
(its bf16 logits against its f32 logits, 7.5 % of the largest at smoke
size): RWKV's per-head group norm divides by the RMS of a 16-wide head
output, so one bf16 rounding placed elsewhere moves its logits by more
than 3 % (3.6 % was seen between the two packages).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import zamba2 as jzamba  # noqa: E402
from repro.models.config import RunConfig  # noqa: E402
from repro.train import serve as jserve  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as port_fa  # noqa: E402
from repro_torch.models import config as port_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import rwkv6, zamba2  # noqa: E402
from repro_torch.train import serve as tserve  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

RECURRENT = ["rwkv6-3b", "zamba2-7b"]
BF16_REL = 3e-2


def _params(arch, seed=0, cfg=None, tcfg=None):
    cfg = cfg or get_smoke_config(arch)
    tcfg = tcfg or port_smoke(arch)
    jp = JL.tree_init(JR.param_defs(cfg), jax.random.PRNGKey(seed))
    return cfg, tcfg, jp, convert.from_numpy(jax.tree.map(np.asarray, jp),
                                             device="cpu")


def _rcs(**kw):
    return RunConfig(**kw), port_config.RunConfig(**kw)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def _zeros(spec):
    return {k: torch.zeros(s, dtype=dt) for k, (s, dt) in spec.items()}


# ------------------------------------------------------------- the scans

def test_wkv_seq_matches_reference():
    """The time loop of RWKV-6 (f32) on random r, k, v, decays in (0, 1),
    a bonus and a non-zero initial state: outputs and final state within
    1e-5."""
    rng = np.random.default_rng(0)
    B, S, H, D = 2, 12, 3, 8
    r, k, v = (rng.standard_normal((B, S, H, D), dtype=np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 1.0, (B, S, H, D)).astype(np.float32)
    u = rng.standard_normal((H, D), dtype=np.float32)
    st = rng.standard_normal((B, H, D, D), dtype=np.float32)
    y, s = jrwkv._wkv_seq(*(jnp.asarray(a) for a in (r, k, v, w, u, st)))
    ty, ts = rwkv6._wkv_seq(*(torch.from_numpy(a) for a in (r, k, v, w, u,
                                                            st)))
    assert np.abs(ty.numpy() - np.asarray(y)).max() < 1e-5
    assert np.abs(ts.numpy() - np.asarray(s)).max() < 1e-5


def _ssd_inputs(seed, B=2, S=32, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P), dtype=np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    dt = rng.uniform(0.05, 1.0, (B, S, H)).astype(np.float32)
    da = -dt * rng.uniform(0.1, 2.0, (H,)).astype(np.float32)
    return xh, Bm, Cm, da, dt


@pytest.mark.parametrize("cdt,tol", [("float32", 1e-5), ("bfloat16", 1e-5)])
@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_ssd_chunked_matches_reference(chunk, cdt, tol):
    """The chunked SSD on the same inputs (the big ones in `cdt`, the
    decays in f32): y and the final state within 1e-5 of the largest
    entry, bf16 included, since both round the same tensors to bf16 and
    contract in f32."""
    xh, Bm, Cm, da, dt = _ssd_inputs(1)
    jd, td = getattr(jnp, cdt), getattr(torch, cdt)
    y, s = jzamba._ssd_chunked(jnp.asarray(xh).astype(jd),
                               jnp.asarray(Bm).astype(jd),
                               jnp.asarray(Cm).astype(jd), jnp.asarray(da),
                               jnp.asarray(dt), chunk, jd)
    ty, ts = zamba2._ssd_chunked(torch.from_numpy(xh).to(td),
                                 torch.from_numpy(Bm).to(td),
                                 torch.from_numpy(Cm).to(td),
                                 torch.from_numpy(da), torch.from_numpy(dt),
                                 chunk, td)
    assert ty.dtype == ts.dtype == torch.float32
    y, s = np.asarray(y), np.asarray(s)
    assert np.abs(ty.numpy() - y).max() < tol * np.abs(y).max()
    assert np.abs(ts.numpy() - s).max() < tol * np.abs(s).max()


def test_ssd_chunks_equal_the_step_by_step_recurrence():
    """f32: the chunked form at chunk 4 and 32 equals the one-step decode
    update applied position by position (the SSM's definition), within
    1e-4 of the largest output."""
    xh, Bm, Cm, da, dt = (torch.from_numpy(a) for a in _ssd_inputs(2))
    B, S, H, P = xh.shape
    state = torch.zeros((B, H, Bm.shape[-1], P))
    ys = []
    for t in range(S):
        kv = torch.einsum("bn,bh,bhp->bhnp", Bm[:, t], dt[:, t], xh[:, t])
        state = torch.exp(da[:, t])[:, :, None, None] * state + kv
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], state))
    want = torch.stack(ys, dim=1)
    for chunk in (4, 32):
        y, s = zamba2._ssd_chunked(xh, Bm, Cm, da, dt, chunk, torch.float32)
        scale = float(want.abs().max())
        assert float((y - want).abs().max()) < 1e-4 * scale, chunk
        assert float((s - state).abs().max()) < 1e-4 * float(
            state.abs().max()), chunk


def test_conv1d_matches_reference_and_carries_its_state():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 6), dtype=np.float32)
    w = rng.standard_normal((4, 6), dtype=np.float32)
    prev = rng.standard_normal((2, 3, 6), dtype=np.float32)
    for p in (None, prev):
        want, wst = jzamba._conv1d(jnp.asarray(x), jnp.asarray(w),
                                   None if p is None else jnp.asarray(p))
        got, st = zamba2._conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                 None if p is None else torch.from_numpy(p))
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-6
        np.testing.assert_array_equal(st.numpy(), np.asarray(wst))


# ----------------------------------------------------------- the models

@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_forward_and_cache_match_reference_f32(arch, impl):
    """B=2 x S=32, f32: hidden states, logits and every cache leaf (RWKV's
    states and shifted inputs; Zamba2's conv and SSM states, tail
    included, and the shared block's K/V) within 1e-5."""
    cfg, tcfg, jp, tp = _params(arch)
    rc, trc = _rcs(seq_len=32, global_batch=2, kind="prefill",
                   attn_impl=impl, compute_dtype="float32", remat="none",
                   ssm_chunk=8)
    toks = _tokens(cfg, 2, 32, 1)
    x, _, cache, _, _ = JR.forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                                   rc, return_cache=True)
    tx, plen, tcache, _, aux = TR.forward(
        tcfg, tp, {"tokens": torch.from_numpy(toks)}, trc, return_cache=True)
    assert plen == 0 and float(aux) == 0.0
    assert np.abs(_f32(tx) - _f32(x)).max() < 1e-5
    assert np.abs(_f32(TR.unembed(tcfg, tp, tx, trc))
                  - _f32(JR.unembed(cfg, jp, x, rc))).max() < 1e-5
    assert set(tcache) == set(cache)
    for name in cache:
        assert tuple(tcache[name].shape) == cache[name].shape, name
        assert np.abs(_f32(tcache[name]) - _f32(cache[name])).max() < 1e-5


@pytest.mark.parametrize("arch", RECURRENT)
def test_forward_matches_reference_bf16(arch):
    cfg, tcfg, jp, tp = _params(arch)
    rc, trc = _rcs(seq_len=32, global_batch=2, kind="prefill",
                   attn_impl="flash", remat="none")
    toks = _tokens(cfg, 2, 32, 2)

    def ref_logits(rc):
        x, *_ = JR.forward(cfg, jp, {"tokens": jnp.asarray(toks)}, rc)
        return _f32(JR.unembed(cfg, jp, x, rc))

    want = ref_logits(rc)
    tx, *_ = TR.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)}, trc)
    got = TR.unembed(tcfg, tp, tx, trc)
    assert got.dtype == torch.bfloat16
    gap = np.abs(_f32(got) - want).max()
    if arch == "rwkv6-3b":
        f32 = ref_logits(dataclasses.replace(rc, compute_dtype="float32"))
        assert gap <= 2 * np.abs(want - f32).max()
    else:
        assert gap < BF16_REL * np.abs(want).max()


def test_rwkv_state_decode_matches_scan():
    """Twin of tests/test_archs.py: RWKV's sequential scan == the
    one-token decode chain with the state carried (within 1e-3 at every
    position, the reference test's limit), and the state after the chain
    equals the state of the forward's cache within 1e-5."""
    cfg, tcfg, jp, tp = _params("rwkv6-3b")
    rc, trc = _rcs(seq_len=8, global_batch=1, kind="train", attn_impl="ref",
                   compute_dtype="float32", param_dtype="float32",
                   remat="none")
    toks = _tokens(cfg, 1, 8, 3)
    with torch.no_grad():
        x, _, fcache, _, _ = TR.forward(
            tcfg, tp, {"tokens": torch.from_numpy(toks)}, trc,
            return_cache=True)
        full = TR.unembed(tcfg, tp, x, trc)
        cache = _zeros(TR.init_cache(tcfg, 1, 8, torch.float32))
        for t in range(8):
            lg, cache = TR.decode(tcfg, tp, cache,
                                  torch.from_numpy(toks[:, t:t + 1]), t, trc)
            err = float((lg[:, 0] - full[:, t]).abs().max())
            assert err < 1e-3, (t, err)
    for name in ("state", "x_att", "x_ffn"):
        assert float((cache[name] - fcache[name]).abs().max()) < 1e-5, name


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_gradients_match_reference_f32(arch, remat):
    """Loss and every gradient leaf against `jax.value_and_grad` of the
    reference `loss_fn`, f32, B=2 x S=16 (Zamba2 at ssm_chunk 8, so its
    inter-chunk scan runs; with remat its blocks and groups are
    checkpointed, nested): loss within 1e-6 relative, each leaf within
    1e-5 (RWKV: 5e-5) of its largest entry."""
    tol = 5e-5 if arch == "rwkv6-3b" else 1e-5
    cfg, tcfg, jp, tp = _params(arch, seed=1)
    rc, trc = _rcs(seq_len=16, global_batch=2, kind="train",
                   attn_impl="ref", compute_dtype="float32", remat=remat,
                   ssm_chunk=8)
    toks = _tokens(cfg, 2, 16, 11)
    labels = np.roll(toks, -1, axis=-1)
    loss, grads = jax.value_and_grad(functools.partial(
        jsteps.loss_fn, cfg, rc=rc))(jp, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)})
    tloss, tgrads = tsteps._value_and_grad(tcfg, trc, tp, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert float(tloss) == pytest.approx(float(loss), rel=1e-6)
    for (path, g), (wpath, w) in zip(
            TL.tree_items(tgrads),
            TL.tree_items(jax.tree.map(np.asarray, grads)), strict=True):
        assert path == wpath
        scale = np.abs(w).max()
        if scale == 0:                 # unreached (a smoke-size corner)
            assert not g.any(), path
            continue
        gap = np.abs(g.numpy() - w).max() / scale
        assert gap < tol, (".".join(path), gap)


def test_zamba2_remat_checkpoints_blocks_inside_groups(monkeypatch):
    """With remat, each group is checkpointed and, inside it, each
    Mamba2 block (nested, as the reference's jax.checkpoint pair); the
    tail blocks one by one."""
    import torch.utils.checkpoint as tuc
    seen = []
    real = tuc.checkpoint

    def spy(fn, *a, **kw):
        seen.append(fn.__name__)
        return real(fn, *a, **kw)

    monkeypatch.setattr(zamba2, "checkpoint", spy)
    cfg, tcfg, _, tp = _params("zamba2-7b")
    _, trc = _rcs(seq_len=8, global_batch=1, kind="train", attn_impl="ref")
    toks = torch.from_numpy(_tokens(tcfg, 1, 8, 4))
    tsteps._value_and_grad(tcfg, trc, tp, {"tokens": toks,
                                           "labels": toks})
    ng, tail = zamba2.n_groups_tail(tcfg)
    assert seen.count("group") == ng
    # each block's checkpoint runs in the forward and again in the
    # recomputation of its group
    assert seen.count("mamba") == 2 * ng * zamba2.GROUP + tail


def test_zamba2_flash_launches_once_a_group(monkeypatch):
    calls = []
    real = port_fa.flash_attention
    monkeypatch.setattr(port_fa, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    _, tcfg, _, tp = _params("zamba2-7b")
    _, trc = _rcs(seq_len=16, global_batch=1, kind="prefill",
                  attn_impl="flash")
    TR.forward(tcfg, tp, {"tokens": torch.zeros((1, 16), dtype=torch.long)},
               trc)
    assert len(calls) == zamba2.n_groups_tail(tcfg)[0] == 2


def test_zamba2_head_dim_112_takes_flash_on_the_cpu():
    """zamba2-7b's shared block has head_dim 112: at that head_dim (and
    narrow otherwise) the flash prefill raises nowhere and equals the
    reference's (Pallas in interpret mode), f32, within 1e-5."""
    kw = dict(d_model=224, n_heads=2, n_kv_heads=2, head_dim=112)
    cfg, tcfg, jp, tp = _params(
        "zamba2-7b", cfg=get_smoke_config("zamba2-7b").scaled(**kw),
        tcfg=port_smoke("zamba2-7b").scaled(**kw))
    rc, trc = _rcs(seq_len=16, global_batch=2, kind="prefill",
                   attn_impl="flash", compute_dtype="float32")
    toks = _tokens(cfg, 2, 16, 5)
    x, _, cache, _, _ = JR.forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                                   rc, return_cache=True)
    tok, tcache = tsteps.build_prefill_step(tcfg, trc, device="cpu")(
        tp, {"tokens": toks})
    want = np.asarray(jnp.argmax(JR.unembed(cfg, jp, x[:, -1:], rc), -1))
    np.testing.assert_array_equal(tok.numpy(), want)
    assert tcache["k"].shape[-1] == 112
    for name in ("k", "v", "state"):
        assert np.abs(_f32(tcache[name]) - _f32(cache[name])).max() < 1e-5


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_and_serve_steps_match_reference(arch):
    """build_prefill_step, f32: the next tokens and every cache leaf of the
    reference's forward; then build_serve_step on a decode_cache takes the
    reference's decode steps token for token."""
    cfg, tcfg, jp, tp = _params(arch)
    rc, trc = _rcs(seq_len=16, global_batch=2, kind="prefill",
                   attn_impl="flash", compute_dtype="float32", ssm_chunk=8)
    toks = _tokens(cfg, 2, 16, 6)
    x, _, cache, _, _ = JR.forward(cfg, jp, {"tokens": jnp.asarray(toks)},
                                   rc, return_cache=True)
    want = np.asarray(jnp.argmax(JR.unembed(cfg, jp, x[:, -1:], rc), -1))
    tok, tcache = tsteps.build_prefill_step(tcfg, trc, device="cpu")(
        tp, {"tokens": toks})
    np.testing.assert_array_equal(tok.numpy(), want)
    for name in cache:
        assert np.abs(_f32(tcache[name]) - _f32(cache[name])).max() < 1e-5
    drc, tdrc = _rcs(seq_len=8, global_batch=2, kind="decode",
                     attn_impl="ref", compute_dtype="float32")
    dcache = tsteps.decode_cache(tcfg, tdrc, device="cpu")
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jsteps.decode_cache_structs(cfg, drc))
    step = tsteps.build_serve_step(tcfg, tdrc, device="cpu")
    t = toks[:, :1]
    for pos in range(6):
        nxt, dcache = step(tp, dcache, t, pos)
        jlg, jcache = JR.decode(cfg, jp, jcache, jnp.asarray(t),
                                jnp.asarray(pos, jnp.int32), drc)
        np.testing.assert_array_equal(nxt.numpy(),
                                      np.asarray(jnp.argmax(jlg, -1)))
        t = nxt.numpy()


@pytest.mark.parametrize("arch", RECURRENT)
def test_server_matches_reference_token_for_token_f32(arch):
    cfg, tcfg, jp, tp = _params(arch)
    ref_srv = jserve.BatchedServer(cfg, jp, max_seq=32)
    ref_srv.rc = dataclasses.replace(ref_srv.rc, compute_dtype="float32")
    srv = tserve.BatchedServer(tcfg, tp, max_seq=32, device="cpu")
    srv.rc = dataclasses.replace(srv.rc, compute_dtype="float32")
    reqs = lambda m: [m.Request(1, [5, 6, 7], max_new=6),
                      m.Request(2, [9], max_new=4)]
    want = ref_srv.generate(reqs(jserve))
    got = srv.generate(reqs(tserve))
    assert [r.out for r in got] == [r.out for r in want]


@pytest.mark.parametrize("arch", RECURRENT)
def test_param_counts_match_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.models.registry import count_params
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    total = sum(int(np.prod(d.shape)) for _, d in
                TL.tree_items(TR.param_defs(cfg)))
    assert TR.count_params(cfg) == count_params(ref_config(arch))
    assert total == {"rwkv6-3b": 3_073_313_280,
                     "zamba2-7b": 6_750_539_856}[arch]
