"""The MoE's row kernels (`repro_torch.kernels.moe_rows`,
`csrc/moe_rows.cu`).

On the CPU: `route` names each reason an MoE layer takes the plain
`_scatter` and `_combine`, a training forward among them; the kernels'
plain versions (which CPU tensors take) give `_scatter`'s buffer and
`_combine`'s y bit for bit, and their slot-to-row map inverts the sort,
on chat-like (16 experts, top-2) and Granite-like (72, top-10) routings
with overflowing experts, an empty expert and tokens with every slot
dropped; the MoE layer forced onto the kernel path gives the plain path's
bits and counts in `moe.kernel`; a CPU prefill counts neither
`moe.kernel` nor `moe.plain`.  On the card (the `card` tests, skipped
without one): the kernels against their plain versions and against
`_scatter` and `_combine` at the cells' widths, and the counts of a
prefill and a training forward.
"""
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import moe_rows  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe, registry  # noqa: E402
from repro_torch.models.config import RunConfig  # noqa: E402
from repro_torch.train import steps  # noqa: E402

# (experts, top-k, tokens): chat's phi3.5-moe and Granite 4.0-H Small's
# routing at a few tokens
ROUTINGS = {"chat": (16, 2, 64), "granite": (72, 10, 96)}
DTYPES = [torch.bfloat16, torch.float16]


def routing(name, seed=0, d=64, dtype=torch.bfloat16, device="cpu"):
    """A layer's inputs with the experts chosen by hand: the first 40 % of
    the tokens all pick experts 0 .. k-1, which overflow, so the last of
    them drop every slot; the last expert is picked by no token; the rest
    pick k distinct experts at random.  Returns (cfg, x, top_p, top_e, C)."""
    E, k, T = ROUTINGS[name]
    cfg = types.SimpleNamespace(n_experts=E, top_k=k, capacity_factor=1.25)
    C = moe.capacity(cfg, T)
    g = torch.Generator().manual_seed(seed)
    top_e = torch.stack([torch.randperm(E - 1 - k, generator=g)[:k] + k
                         for _ in range(T)])
    crowd = int(0.4 * T)
    assert crowd > C, "the crowd must overflow its experts"
    top_e[:crowd] = torch.arange(k)
    top_p = torch.rand(T, k, generator=g) + 0.01
    top_p = top_p / top_p.sum(-1, keepdim=True)
    x = torch.randn(T, d, generator=g).to(dtype)
    return (cfg, x.to(device), top_p.to(device), top_e.to(device), C)


def expert_out(E, C, d, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(E, C, d, generator=g).to(dtype).to(device)


# ------------------------------------------------------------ on the CPU

def _reason(case):
    _, x, top_p, _, _ = routing("chat")
    cdt = torch.bfloat16
    if case == "grad":
        x = x.float().requires_grad_()
    elif case == "dtype":
        cdt = torch.float32
    elif case == "layout":
        x = torch.randn(64, 2 * x.shape[1]).to(cdt)[:, ::2]
    return moe_rows.route(x, top_p, cdt)


@pytest.mark.parametrize("case", ["grad", "dtype", "layout", "device"])
def test_route_names_each_reason(case):
    assert _reason(case) == case


@pytest.mark.parametrize("x_dtype,cdt,d,why", [
    (torch.float32, torch.bfloat16, 64, "device"),   # cast, then dense
    (torch.float32, torch.float16, 64, "device"),
    (torch.bfloat16, torch.bfloat16, 12, "layout"),  # 24-byte rows
    (torch.float32, torch.bfloat16, 12, "layout"),
    (torch.float16, torch.float32, 64, "dtype")])
def test_route_reads_x_in_the_compute_type(x_dtype, cdt, d, why):
    _, x, top_p, _, _ = routing("chat", d=d)
    assert moe_rows.route(x.to(x_dtype), top_p, cdt) == why


def test_route_under_no_grad_and_with_gates_not_float32():
    _, x, top_p, _, _ = routing("granite")
    with torch.no_grad():
        assert moe_rows.route(x.float().requires_grad_(), top_p,
                              torch.bfloat16) == "device"
    assert moe_rows.route(x, top_p.double(), torch.bfloat16) == "dtype"


def test_training_forward_routes_every_layer_to_grad(monkeypatch):
    """A training forward of the phi3.5-moe smoke config, parameters
    needing gradients, in bf16: each MoE layer's route says "grad", so
    `train_4k` keeps `_scatter` and `_combine`."""
    cfg = get_smoke_config("phi3.5-moe")
    rc = RunConfig(seq_len=32, global_batch=2, kind="train",
                   param_dtype="float32", compute_dtype="bfloat16")
    params = L.tree_init(registry.param_defs(cfg),
                         torch.Generator().manual_seed(0), torch.float32)
    params = L.tree_map(lambda t: t.requires_grad_(), params)
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    seen = []
    route = moe_rows.route

    def spy(*a):
        seen.append(route(*a))
        return seen[-1]

    monkeypatch.setattr(moe_rows, "route", spy)
    trace.reset()
    trace.enable()
    try:
        loss = steps.loss_fn(cfg, params, {"tokens": toks, "labels": toks},
                             rc)
        got = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert bool(torch.isfinite(loss))
    assert seen == ["grad"] * cfg.n_layers
    assert "moe.kernel" not in got and "moe.plain" not in got


@pytest.mark.parametrize("name", sorted(ROUTINGS))
def test_routing_has_the_edges_it_is_built_for(name):
    cfg, _, _, top_e, C = routing(name)
    E, k, T = ROUTINGS[name]
    _, dest, keep = moe.dispatch(cfg, top_e, C)
    counts = torch.bincount(top_e.reshape(-1), minlength=E)
    assert int(counts.max()) > C and int(counts[-1]) == 0
    assert bool((~keep).any()) and bool(keep.any())
    slots = torch.empty_like(keep)
    slots[moe.dispatch(cfg, top_e, C)[0]] = keep
    assert bool((~slots.view(T, k)).all(dim=1).any()), \
        "a token with every slot dropped"


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(ROUTINGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_dispatch_is_scatters_buffer(name, dtype, seed):
    cfg, x, _, top_e, C = routing(name, seed, dtype=dtype)
    E, k, _ = ROUTINGS[name]
    order, dest, _ = moe.dispatch(cfg, top_e, C)
    buf, _ = moe_rows.dispatch_rows_plain(x, order, dest, E, C, k)
    want = moe._scatter(x, order, dest, E, C, k, dtype)
    assert buf.dtype == want.dtype and buf.shape == want.shape
    assert torch.equal(buf, want)
    got, _ = moe_rows.dispatch_rows(x, order, dest, E, C, k)   # CPU: plain
    assert torch.equal(got, want)


@pytest.mark.parametrize("counts", [(16, 5, 0, 11), (16, 16, 0, 0),
                                    (0, 0, 16, 16), (20, 0, 12, 0)])
def test_plain_dispatch_at_experts_filled_to_capacity(counts):
    """Experts filled to exactly C, beside empty and overflowing ones:
    the last kept assignment of a full expert is row C - 1, and the next
    expert's first row follows it."""
    cfg = types.SimpleNamespace(n_experts=4, top_k=1, capacity_factor=1.25)
    T = sum(counts)
    C = moe.capacity(cfg, 32)
    assert C == 16
    top_e = torch.repeat_interleave(torch.arange(4), torch.tensor(counts))
    top_e = top_e[torch.randperm(T, generator=torch.Generator()
                                 .manual_seed(T))][:, None]
    x = torch.randn(T, 16, generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16)
    order, dest, _ = moe.dispatch(cfg, top_e, C)
    buf, _ = moe_rows.dispatch_rows_plain(x, order, dest, 4, C, 1)
    assert torch.equal(buf, moe._scatter(x, order, dest, 4, C, 1,
                                         torch.bfloat16))


@pytest.mark.parametrize("name", sorted(ROUTINGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_row_inverts_the_sort(name, seed):
    cfg, x, _, top_e, C = routing(name, seed)
    E, k, T = ROUTINGS[name]
    order, dest, keep = moe.dispatch(cfg, top_e, C)
    _, slot_row = moe_rows.dispatch_rows_plain(x, order, dest, E, C, k)
    inv = torch.argsort(order)
    want = torch.where(keep[inv], dest[inv], -1)
    assert slot_row.dtype == torch.int32 and slot_row.shape == (T * k,)
    assert torch.equal(slot_row.long(), want)
    kept = slot_row[slot_row >= 0]
    assert kept.unique().numel() == kept.numel() == int(keep.sum())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(ROUTINGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_combine_is_combines_y(name, dtype, seed):
    cfg, x, top_p, top_e, C = routing(name, seed, dtype=dtype)
    E, k, _ = ROUTINGS[name]
    order, dest, _ = moe.dispatch(cfg, top_e, C)
    out = expert_out(E, C, x.shape[1], dtype, seed + 10)
    _, slot_row = moe_rows.dispatch_rows_plain(x, order, dest, E, C, k)
    y = moe_rows.combine_rows_plain(out, slot_row, top_p)
    want = moe._combine(out, dest, order, top_p, k)
    assert y.dtype == want.dtype and y.shape == want.shape
    assert torch.equal(y, want)
    assert torch.equal(moe_rows.combine_rows(out, slot_row, top_p), want)


def test_a_token_with_every_slot_dropped_combines_to_zero():
    cfg, x, top_p, top_e, C = routing("granite")
    E, k, T = ROUTINGS["granite"]
    order, dest, _ = moe.dispatch(cfg, top_e, C)
    out = expert_out(E, C, x.shape[1], x.dtype, 5)
    _, slot_row = moe_rows.dispatch_rows_plain(x, order, dest, E, C, k)
    gone = (slot_row.view(T, k) < 0).all(dim=1)
    y = moe_rows.combine_rows_plain(out, slot_row, top_p)
    assert bool(gone.any()) and not bool(y[gone].any())
    assert bool(y[~gone].any(dim=1).all())


def _layer(dtype=torch.bfloat16):
    """A phi3.5-moe smoke layer's MoE parameters and inputs whose router
    overflows expert 0, in the compute type `dtype`."""
    cfg = get_smoke_config("phi3.5-moe")
    g = torch.Generator().manual_seed(3)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {"router": torch.randn(d, E, generator=g) * 0.1,
         "wg": torch.randn(E, d, f, generator=g) * 0.1,
         "wu": torch.randn(E, d, f, generator=g) * 0.1,
         "wd": torch.randn(E, f, d, generator=g) * 0.1}
    p["router"][:, 0] += 0.05
    x = (torch.randn(96, d, generator=g) + 1.0).to(dtype)
    rc = RunConfig(seq_len=96, global_batch=1, kind="prefill",
                   compute_dtype=str(dtype).removeprefix("torch."))
    return cfg, p, x, rc


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_layer_on_the_kernel_path_gives_the_plain_paths_bits(dtype,
                                                             monkeypatch):
    """The MoE layer with `route` forced to "kernel" (on the CPU the
    wrappers run the plain versions): the same y, aux and dropped count
    as `_scatter` and `_combine`, one `moe.kernel`, no `moe.plain`."""
    cfg, p, x, rc = _layer(dtype)
    with torch.no_grad():
        want_stats, got_stats = {}, {}
        want = moe._moe_ffn_global(cfg, p, x, rc, want_stats)
        monkeypatch.setattr(moe_rows, "route", lambda *a: "kernel")
        trace.reset()
        trace.enable()
        try:
            got = moe._moe_ffn_global(cfg, p, x, rc, got_stats)
            counts = trace.counters()
        finally:
            trace.disable()
            trace.reset()
    assert want_stats["dropped"] > 0
    assert got_stats == want_stats
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert counts["moe.kernel"] == 1 and "moe.plain" not in counts
    assert counts["moe.kept"] == x.shape[0] * cfg.top_k - \
        want_stats["dropped"]


def test_counters_are_known_and_a_cpu_prefill_counts_none():
    assert {"moe.kernel", "moe.plain"} <= set(trace.COUNTERS)
    cfg = get_smoke_config("phi3.5-moe")
    rc = RunConfig(seq_len=64, global_batch=1, kind="prefill",
                   param_dtype="bfloat16")
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
    assert got["moe.assignments"] > 0
    assert "moe.kernel" not in got and "moe.plain" not in got


@pytest.mark.parametrize("what", ["dispatch", "combine"])
def test_wrappers_refuse_tensors_off_the_cpu_that_route_refuses(what):
    """A tensor neither on the CPU nor on a card (the meta device) is
    refused for its device, and nothing is counted as launched."""
    cfg, x, top_p, top_e, C = routing("chat")
    E, k, _ = ROUTINGS["chat"]
    order, dest, _ = moe.dispatch(cfg, top_e, C)
    launches = moe_rows.LAUNCHES
    with pytest.raises(ValueError, match="device"):
        if what == "dispatch":
            moe_rows.dispatch_rows(x.to("meta"), order, dest, E, C, k)
        else:
            _, slot_row = moe_rows.dispatch_rows_plain(x, order, dest, E, C,
                                                       k)
            moe_rows.combine_rows(expert_out(E, C, 64, x.dtype, 0).to(
                "meta"), slot_row, top_p)
    assert moe_rows.LAUNCHES == launches


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _ulps(a, b):
    """|a - b| in units in the last place of the 16-bit type, elementwise
    (the bit patterns as ordered integers)."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return (ordered(a) - ordered(b)).abs()


def _held(name, dtype, seed, device, d=256):
    cfg, x, top_p, top_e, C = routing(name, seed, d, dtype, device)
    E, k, _ = ROUTINGS[name]
    order, dest, _ = moe.dispatch(cfg, top_e, C)
    launches = moe_rows.LAUNCHES
    with torch.no_grad():
        assert moe_rows.route(x, top_p, dtype) == "kernel"
        buf, slot_row = moe_rows.dispatch_rows(x, order, dest, E, C, k)
        out = expert_out(E, C, d, dtype, seed + 10, device)
        y = moe_rows.combine_rows(out, slot_row, top_p)
        y2 = moe_rows.combine_rows(out, slot_row, top_p)
        buf_p, slot_p = moe_rows.dispatch_rows_plain(x, order, dest, E, C, k)
        y_p = moe_rows.combine_rows_plain(out, slot_row, top_p)
        want = moe._combine(out, dest, order, top_p, k)
    torch.cuda.synchronize()
    assert moe_rows.LAUNCHES == launches + 3
    assert torch.equal(buf, moe._scatter(x, order, dest, E, C, k, dtype))
    assert torch.equal(buf, buf_p) and torch.equal(slot_row, slot_p)
    assert torch.equal(y, y_p) and torch.equal(y, y2)
    assert int(_ulps(y, want).max()) <= 1


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(ROUTINGS))
def test_card_kernels_hold_to_the_plain_versions(card, name, dtype):
    _held(name, dtype, 0, card)


@pytest.mark.parametrize("d", [8, 24, 4096])
def test_card_row_widths(card, d):
    _held("granite", torch.bfloat16, 1, card, d)


def test_card_prefill_counts_the_kernel_in_every_layer(card):
    cfg = get_smoke_config("phi3.5-moe")
    rc = RunConfig(seq_len=256, global_batch=1, kind="prefill",
                   param_dtype="bfloat16", attn_impl="ref")
    gen = torch.Generator(device=card).manual_seed(0)
    params = L.tree_init(registry.param_defs(cfg), gen, torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (1, rc.seq_len), device=card,
                         generator=gen, dtype=torch.int32)
    trace.reset()
    trace.enable()
    try:
        steps.build_prefill_step(cfg, rc, device=card)(
            params, {"tokens": toks})
        got = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    assert got["moe.kernel"] == cfg.n_layers
    assert "moe.plain" not in got
