"""The SSD kernel (`repro_torch.kernels.ssd`, `csrc/ssd.cu`).

On the CPU: `route` names each reason a block's SSD takes the plain
`zamba2._ssd_chunked`, the wrapper refuses what `route` does not send to
the kernel, and a CPU prefill counts nothing in `ssd.chunked` or
`ssd.launches`.  On the card (the `card` tests, skipped without one, no
JAX): the kernel against `_ssd_chunked` on the same card with TF32 off, at
zamba2-7b's widths (H = 112, P = N = 64) and Granite 4.0-H Small's (H =
128, P = 64, N = 128) at the cells' prompt lengths, from inputs drawn as
the benchmark's zamba2 draws its Mamba2 leaves; and a prefill that takes
the kernel in every block, or `_ssd_chunked` with the kernel refused,
for the same next token.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry, zamba2  # noqa: E402
from repro_torch.models.config import RunConfig  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from _card import card, prefill, same_answer, ssd_close  # noqa: E402,F401

P = N = 64


def inputs(B, S, H, seed, device="cpu", heads=None, n=N):
    """A block's SSD inputs as `_mamba_block` hands them: xh, Bm, Cm views
    of one (B, S, H P + 2 N) bf16 activation, silu of normal draws; dt =
    softplus(raw + dt_bias) with dt_bias = softplus^-1 of dt0, log dt0
    uniform in [log 0.001, log 0.1]; da = -exp(a_log) dt with exp(a_log)
    uniform in [1, 16].  `heads` (a slice) keeps those heads of each, as
    views, as a head-sharded block sees them; `n` is the state size."""
    g = torch.Generator().manual_seed(seed)
    d_in = H * P
    xbc = torch.nn.functional.silu(
        torch.randn(B, S, d_in + 2 * n, generator=g)).to(torch.bfloat16)
    u = torch.rand(H, generator=g)
    dt0 = torch.exp(math.log(1e-3) + (math.log(0.1) - math.log(1e-3)) * u)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    a = -(1.0 + 15.0 * torch.rand(H, generator=g))
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g) + dt_bias)
    xbc, dt, a = xbc.to(device), dt.to(device), a.to(device)
    da = dt * a
    xh = xbc[..., :d_in].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., d_in:d_in + n], xbc[..., d_in + n:]
    if heads is not None:
        xh, dt, da = xh[:, :, heads], dt[..., heads], da[..., heads]
    return xh, Bm, Cm, da, dt


# ------------------------------------------------------------ on the CPU

def _reason(case):
    xh, Bm, Cm, da, dt = inputs(1, 64, 4, 0)
    chunk, cdt = 32, torch.bfloat16
    if case == "grad":
        xh = xh.detach().requires_grad_()
    elif case == "dtype":
        xh = xh.float()
    elif case == "dims":
        Bm, Cm = Bm[..., :32], Cm[..., :32]
    elif case == "chunk":
        chunk = 8
    elif case == "layout":
        xh = xh.transpose(-1, -2).contiguous().transpose(-1, -2)
    return ssd.route(xh, Bm, Cm, da, dt, chunk, cdt)


@pytest.mark.parametrize("case", ["grad", "dtype", "dims", "chunk",
                                  "layout", "device"])
def test_route_names_each_reason(case):
    assert _reason(case) == case


@pytest.mark.parametrize("n,why", [(64, "device"), (128, "device"),
                                   (96, "dims"), (32, "dims")])
def test_route_takes_the_state_sizes_of_dims(n, why):
    """N = 64 and N = 128 pass every check a CPU tensor can pass (the
    kernel's only refusal left is the device); other sizes go to the
    plain version for their dims."""
    assert ssd.route(*inputs(1, 64, 4, 3, n=n), 32, torch.bfloat16) == why


def test_route_under_no_grad_and_at_chunks_it_does_not_take():
    xh, Bm, Cm, da, dt = inputs(1, 64, 4, 1)
    with torch.no_grad():      # a prefill's inputs need no gradient there
        assert ssd.route(xh.detach().requires_grad_(), Bm, Cm, da, dt, 32,
                         torch.bfloat16) == "device"
    assert ssd.route(xh, Bm, Cm, da, dt, 32, torch.float16) == "dtype"
    assert ssd.route(xh, Bm, Cm, da, dt, 48, torch.bfloat16) == "chunk"
    assert ssd.route(xh, Bm, Cm, da, dt, 128, torch.bfloat16) == "chunk"


def test_wrapper_refuses_what_route_does_not_send():
    xh, Bm, Cm, da, dt = inputs(1, 64, 4, 2)
    launches = ssd.LAUNCHES
    with pytest.raises(ValueError, match="device"):
        ssd.ssd_chunked(xh, Bm, Cm, da, dt, 32)
    assert ssd.LAUNCHES == launches


def test_cpu_prefill_counts_no_chunked_block_and_no_launch():
    cfg = get_smoke_config("zamba2-7b")
    rc = RunConfig(seq_len=64, global_batch=1, kind="prefill",
                   param_dtype="bfloat16", ssm_chunk=32)
    gen = torch.Generator().manual_seed(0)
    params = L.tree_init(registry.param_defs(cfg), gen, torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (1, rc.seq_len), generator=gen,
                         dtype=torch.int32)
    trace.reset()
    trace.enable()
    try:
        steps.build_prefill_step(cfg, rc, device="cpu")(
            params, {"tokens": toks})
        got = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert "ssd.chunked" not in got
    assert got["ssd.launches"] == 0


# ------------------------------------------------------------- on the card

def _held(ins, chunk):
    """The kernel's (y, state) against `_ssd_chunked`'s on the card."""
    launches = ssd.LAUNCHES
    with torch.no_grad():
        assert ssd.route(*ins, chunk, torch.bfloat16) == "kernel"
        y, st = ssd.ssd_chunked(*ins, chunk)
        y_r, st_r = zamba2._ssd_chunked(*ins, chunk, torch.bfloat16)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES == launches + 1
    ssd_close((y, st), (y_r, st_r))


@pytest.mark.parametrize("S", [256, 512, 4096, 1024, 2048, 6144, 8192])
def test_card_zamba2_shapes(card, S):
    _held(inputs(1, S, 112, S, card), 256)


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
def test_card_other_chunks(card, chunk):
    _held(inputs(1, 512, 112, chunk, card), chunk)


def test_card_batch_of_two(card):
    _held(inputs(2, 1024, 112, 7, card), 256)


def test_card_head_slice_as_local_map_hands_it(card):
    _held(inputs(1, 1024, 112, 11, card, heads=slice(56, 112)), 256)


@pytest.mark.parametrize("S", [256, 4096, 8192, 2048, 6144])
@pytest.mark.parametrize("chunk", [256, 128])
def test_card_granite_shapes(card, S, chunk):
    """Granite 4.0-H Small's blocks: H = 128, P = 64, N = 128, B = 2."""
    _held(inputs(2, S, 128, S + chunk, card, n=128), chunk)


@pytest.mark.parametrize("forced", [False, True], ids=["kernel", "plain"])
def test_card_prefill_takes_the_kernel_in_every_block(card, forced,
                                                      monkeypatch):
    """zamba2's smoke config at the kernel's widths, a bf16 prefill: one
    SSD launch a block and no `_ssd_chunked`; with `route` forced to
    refuse, `_ssd_chunked` in every block and no launch, for the same
    next token (`same_answer`)."""
    cfg = get_smoke_config("zamba2-7b")
    cfg = cfg.scaled(ssm_state=N, ssm_head_dim=P, d_inner=4 * P)
    rc = RunConfig(seq_len=512, global_batch=1, kind="prefill",
                   param_dtype="bfloat16", attn_impl="ref", ssm_chunk=256)
    gen = torch.Generator(device=card).manual_seed(0)
    params = L.tree_init(registry.param_defs(cfg), gen, torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (1, rc.seq_len), device=card,
                         generator=gen, dtype=torch.int32)
    kernel = prefill(cfg, rc, params, toks, card)
    got = kernel[2]
    assert got["ssd.launches"] == cfg.n_layers
    assert "ssd.chunked" not in got
    if forced:
        monkeypatch.setattr(ssd, "route", lambda *a: "forced")
        plain = prefill(cfg, rc, params, toks, card)
        assert plain[2]["ssd.chunked"] == cfg.n_layers
        assert plain[2].get("ssd.launches", 0) == 0
        same_answer(kernel, plain)
