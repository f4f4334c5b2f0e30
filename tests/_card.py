"""What the card tests and `chip_smoke.py`'s kernel timings share: the one
limit each hand-written kernel is held to against its plain version, the
`card` fixture, and a step run with each kernel's launches counted.

It imports no JAX, so `chip_smoke.py` reads it on the card's machine
too (it puts `tests/` on its path).  The XOR kernel is held bit for bit
and needs no limit here.
"""
import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_rows, ref, ssd
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.train import steps


@pytest.fixture
def card():
    """The card, with TF32 off for the plain versions' matmuls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


# ------------------------------------------------- flash attention (K3)

# by output type: the reference's own 2e-5 in float32 and 2e-2 in
# bfloat16 (one rounding of the output); 5e-3 in float16 (see
# test_torch_flash.py's docstring)
TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 5e-3}


def close(got, want):
    """TOL for a float32 or 16-bit output, one rounding for float8."""
    name = str(want.dtype).removeprefix("torch.")
    if name in TOL:
        err = (got.float() - want.float()).abs().max()
        assert err < TOL[name], (name, float(err))
    else:
        assert ref.rounding_steps(got, want) <= 1


# The tensor-core kernels round P to their compute type C before P V (the
# row sums keep it unrounded): each weight moves by at most half a unit
# of C, so the unrounded output by at most that share of |v|_P, the
# P-weighted mean of |v| along the row.  Near zero that is many steps of
# a fine float8 format (e5m2's subnormals are 2^-16 apart), so one
# rounding of the output does not hold it; u_C, twice the half unit, is
# the bracket for these routes.
U_C = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -10,
       fa.TF32: 2.0 ** -10}
# float32 sums taken in another order: the simt kernels' unrounded output
# lies within this share of |v|_P of the plain version's (below 2^-20 at
# the card tests' shapes on an H100: 1.0e-6 at |v|_P about 0.8)
F32_ORDER = 2.0 ** -16


def close_on_route(got, q, k, v, **kw):
    """The kernel's output against the plain version on the route it took:
    the rounding to got's type of some x within u |v|_P of the plain
    version's float32 output, element by element (between the roundings
    of its two ends; NaN only where an end is NaN), u = U_C[C] on the
    tensor cores and F32_ORDER on simt (float32 throughout), which is
    held to `close` as well."""
    if fa.route(q, k, v) == "simt":
        close(got.cpu(), ref.flash_attention_ref(q, k, v, **kw).cpu())
        u = F32_ORDER
    else:
        u = U_C[fa.compute_type(q.dtype, k.dtype, v.dtype)]
    dq = ref.decode(q)
    x0 = ref.flash_attention_ref(dq, k, v, **kw)
    margin = u * ref.flash_attention_ref(dq, k, ref.decode(v).abs(), **kw)
    lo = ref.decode(ref.round_to(x0 - margin, got.dtype))
    hi = ref.decode(ref.round_to(x0 + margin, got.dtype))
    g = ref.decode(got)
    inside = ((g >= torch.where(torch.isnan(lo), -np.inf, lo))
              & (g <= torch.where(torch.isnan(hi), np.inf, hi)))
    ok = torch.where(torch.isnan(g), torch.isnan(lo) | torch.isnan(hi),
                     inside & ~torch.isnan(x0))
    assert bool(ok.all()), int((~ok).sum())


# At long sequences a fixed limit is loose: there the kernel's output is
# also held element by element within r (|want| + |v|_P / 2) + a, |v|_P
# the plain version run on |v| (the P-weighted mean of |v| along the row),
# (r, a) by q's type.  r |want| covers the rounding of both outputs, r/2
# |v|_P the kernel's rounding of P before P V (2^-9 a bfloat16 weight,
# with room); float16 rounds 4 times finer.  At S=4096 a typical bfloat16
# output is 0.03-0.04 and this limit about 3.5e-3, where TOL would pass a
# dropped or repeated KV tile.
SCALED = {"float32": (2.0 ** -17, 2e-5), "bfloat16": (2.0 ** -7, 1e-4),
          "float16": (2.0 ** -9, 1e-4)}


def scaled_ok(got, q, k, v, **kw):
    want = ref.flash_attention_ref(q, k, v, **kw).float()
    mean_v = ref.flash_attention_ref(q, k, ref.decode(v).abs(), **kw)
    r, a = SCALED[str(q.dtype).removeprefix("torch.")]
    limit = r * (want.abs() + mean_v.float() / 2) + a
    return bool(((got.float() - want).abs() <= limit).all())


# ------------------------------------------------------------- the SSD

# y and the final state against `_ssd_chunked`: relative Frobenius norm
# (the kernel sums in another order; a bf16 or tf32 rounding of an
# operand held in float32 would be near 2^-9)
SSD_REL_TOL = 1e-4
# element by element, y within SSD_REL_TOL of max|y| but where an att_ij
# lies so near a bf16 rounding boundary that the two sums of C_i . B_j
# round it to neighbours: one bf16 step of att_ij x_jp, at most 2^-8 of
# max|y|, in at most SSD_FLIP_SHARE of the elements
SSD_FLIP_TOL = 2.0 ** -8
SSD_FLIP_SHARE = 1e-3


def ssd_close(got, want):
    """The kernel's (y, state) against `_ssd_chunked`'s."""
    (y, st), (y_r, st_r) = got, want
    assert y.shape == y_r.shape and st.shape == st_r.shape
    for a, b in ((y, y_r), (st, st_r)):
        assert bool(torch.isfinite(a).all())
        rel = float((a - b).norm() / b.norm())
        assert rel <= SSD_REL_TOL, rel
    off = (y - y_r).abs()
    top = float(y_r.abs().max())
    assert float(off.max()) <= SSD_FLIP_TOL * top
    assert float((off > SSD_REL_TOL * top).float().mean()) <= SSD_FLIP_SHARE


# ---------------------------------------------------- the MoE row kernels

def ulps(a, b):
    """|a - b| in units in the last place of the 16-bit type, elementwise
    (the bit patterns as ordered integers)."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return (ordered(a) - ordered(b)).abs()


def moe_rows_close(buf, want_buf, y, want):
    """The dispatch's buffer against `_scatter`'s to the bit; the
    combine's y against `_combine`'s within one unit in the last place
    (the kernel sums the slots in order, `_combine` in another)."""
    assert torch.equal(buf, want_buf)
    assert int(ulps(y, want).max()) <= 1


# ------------------------------------------------------ counted steps

# a prefill on a kernel against the same prefill with the kernel's route
# forced to refuse: the last position's logits, largest gap over the
# largest logit (each layer's output within the kernel's limit, rounded
# to bfloat16 between layers)
LOGIT_GAP = 1e-2


def counted(fn):
    """fn() with the tracer on: its result, and the counters with each
    wrapper's launches beside them (`ssd`, `flash`, `moe_rows`)."""
    kernels = {"ssd": ssd, "flash": fa, "moe_rows": moe_rows}
    before = {n: m.LAUNCHES for n, m in kernels.items()}
    trace.reset()
    trace.enable()
    try:
        out = fn()
        torch.cuda.synchronize()
        got = trace.counters()
    finally:
        trace.disable()
        trace.reset()
    got.update({n: m.LAUNCHES - before[n] for n, m in kernels.items()})
    return out, got


def prefill(cfg, rc, params, toks, device):
    """A prefill step's next token and counts (`counted`), and the last
    position's logits of the same forward."""
    (tok, _), got = counted(lambda: steps.build_prefill_step(
        cfg, rc, device=device)(params, {"tokens": toks}))
    with torch.no_grad():
        x, *_ = registry.forward(cfg, params, {"tokens": toks}, rc)
        logits = registry.unembed(cfg, params, x[:, -1:], rc).float()
    return tok, logits, got


def same_answer(got, want):
    """Two prefills' (tok, logits): the same next token, logits within
    LOGIT_GAP."""
    gap = float((got[1] - want[1]).abs().max() / want[1].abs().max())
    assert gap <= LOGIT_GAP and torch.equal(got[0], want[0]), gap


def train_step(cfg, rc, params, toks):
    """A training forward and backward, counted: the gradients of every
    leaf of `params` and the counts."""
    leaves = [t.requires_grad_() for _, t in L.tree_items(params)]
    return counted(lambda: torch.autograd.grad(steps.loss_fn(
        cfg, params, {"tokens": toks, "labels": toks}, rc), leaves))
