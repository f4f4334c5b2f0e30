"""Zamba2: a Mamba2 (SSD) backbone with a shared attention block,
`repro.models.zamba2` in PyTorch.

81 blocks = 13 groups x 6 Mamba2 blocks + 3 tail Mamba2 blocks; ONE shared
attention+MLP block (single weight set) is applied after every group, each
application with its own KV-cache slot (13 slots).  Per-application LoRA
adapters are omitted, as in the reference.

SSD runs in the chunked parallel form for train/prefill (`_ssd_chunked`,
chunk `rc.ssm_chunk`) with the reference's dtypes: the decay cumsum/exp in
f32, the big (B,nc,Q,Q,H) intra-chunk term cast to the compute dtype, and
every contraction taken in f32 (the reference's preferred_element_type).
A bf16 prefill on the card computes the same in `kernels.ssd` instead,
with no (B,nc,Q,Q,H) tensor in device memory.
Decode is a one-step state update, written into the cache in place.  With
`rc.remat == "full"` each Mamba2 block is recomputed in the backward pass,
and so is each whole group (shared attention included), nested as in the
reference.  The shared attention takes the flash kernel under
`attn_impl="flash"` (one global window, no prefix), at head_dim 112 for
zamba2-7b.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch import trace
from repro_torch.kernels import ssd
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import shardings as sh
from repro_torch.parallel.shardings import constrain

GROUP = 6          # mamba blocks per shared-attention application


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner or 2 * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_in // P
    N = cfg.ssm_state
    conv_dim = d_in + 2 * N
    return d_in, H, P, N, conv_dim


def n_groups_tail(cfg: ModelConfig):
    return cfg.n_layers // GROUP, cfg.n_layers % GROUP


def _mamba_defs(cfg: ModelConfig, lead: tuple[int, ...]):
    d = cfg.d_model
    d_in, H, P, N, conv_dim = _dims(cfg)
    proj_out = 2 * d_in + 2 * N + H
    D = lambda *s, lg=None, init="normal": L.ParamDef(
        (*lead, *s), (None,) * len(lead) + (lg or (None,) * len(s)), init)
    defs = {
        "ln": D(d, init="zeros"),
        "in_proj": D(d, proj_out, lg=(None, "model")),
        "conv_w": D(cfg.conv_width, conv_dim, init="zeros"),
        "a_log": D(H, init="zeros"),
        "dt_bias": D(H, init="zeros"),
        "skip_d": D(H, init="ones"),
        "gn": D(d_in, init="zeros"),
        "out_proj": D(d_in, d, lg=("model", None)),
    }
    if cfg.conv_bias:
        defs["conv_b"] = D(conv_dim, init="zeros")
    return defs


def param_defs(cfg: ModelConfig):
    d, V = cfg.d_model, cfg.vocab
    ng, tail = n_groups_tail(cfg)
    defs = {
        "embed": L.ParamDef((V, d), ("model", None), scale=float(np.sqrt(d))),
        "final_ln": L.ParamDef((d,), (None,), init="zeros"),
        "mamba_groups": _mamba_defs(cfg, (ng, GROUP)),
        "shared_attn": {"attn": tfm._attn_defs(cfg, 1),
                        "mlp": tfm._mlp_defs(cfg, 1)},
        "lm_head": L.ParamDef((d, V), (None, "model")),
    }
    if tail:
        defs["mamba_tail"] = _mamba_defs(cfg, (tail,))
    return defs


# ------------------------------------------------------------------ SSD

def _conv1d(x, w, x_prev=None):
    """Causal depthwise conv. x: (B,S,C), w: (W,C). x_prev: (B,W-1,C).
    Returns (out, the last W-1 inputs)."""
    W = w.shape[0]
    pad = torch.zeros_like(x[:, : W - 1]) if x_prev is None else x_prev
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(W))
    return out, xp[:, -(W - 1):]


def _ssd_chunked(xh, Bm, Cm, da, dt, chunk, cdt=torch.bfloat16):
    """Chunked SSD. xh:(B,S,H,P) Bm/Cm:(B,S,N) da:(B,S,H) (log-decay <0),
    dt:(B,S,H). Returns y:(B,S,H,P) f32, final state (B,H,N,P) f32."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // chunk
    r = lambda a: a.reshape(Bsz, nc, chunk, *a.shape[2:])
    xh, Bm, Cm, da, dt = r(xh), r(Bm), r(Cm), r(da), r(dt)
    seg = torch.cumsum(da, dim=2)                       # (B,nc,Q,H) f32
    seg_last = seg[:, :, -1:]                           # (B,nc,1,H)
    # intra-chunk ("diagonal") term
    li = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    Lm = torch.where(mask[None, None, :, :, None], torch.exp(li),
                     torch.zeros((), device=xh.device))
    cb = torch.einsum("bcin,bcjn->bcij", Cm.float(), Bm.float())
    att = (cb[..., None] * Lm * dt[:, :, None, :, :]).to(cdt)
    y = torch.einsum("bcijh,bcjhp->bcihp", att.float(), xh.float())
    # chunk-local end states
    dec = torch.exp(seg_last - seg)                     # (B,nc,Q,H)
    st = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bm.float(),
                      (dec * dt).to(cdt).float(), xh.float())
    # inter-chunk scan
    gl = torch.exp(seg_last[:, :, 0])                   # (B,nc,H)
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                        device=xh.device)
    prevs = []
    with L.loop("zamba2.chunks", nc) as trips:
        for c in range(trips):
            prevs.append(state)
            state = gl[:, c, :, None, None] * state + st[:, c]
    Sprevs = torch.stack(prevs * (nc // trips), dim=1)  # (B,nc,H,N,P)
    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp", Cm.float(), Sprevs,
                           torch.exp(seg))
    return (y + y_inter).reshape(Bsz, S, H, P), state


def _ssd(xh, Bm, Cm, da, dt, state, chunk: int, cdt):
    """The SSD of a block: chunked over the sequence without a state,
    else one decode step (S == 1) from `state`.  Returns (y f32, state).
    The chunked form runs on the card's SSD kernel where `ssd.route` takes
    the inputs (a bf16 prefill on CUDA tensors), else `_ssd_chunked`.

    On DTensors it runs on each device's own batch rows (dp axes) and
    heads ("model") through `local_map`: DTensor's einsum would merge a
    sharded head dim into a strided layout that its products do not
    take.  B and C feed every head, so their gradients are partial sums
    over "model"."""
    def run(xh, Bm, Cm, da, dt, state):
        if state is None:
            if ssd.route(xh, Bm, Cm, da, dt, chunk, cdt) == "kernel":
                return ssd.ssd_chunked(xh, Bm, Cm, da, dt, chunk)
            if xh.is_cuda:
                trace.add("ssd.chunked", 1)
            return _ssd_chunked(xh, Bm, Cm, da, dt, chunk, cdt)
        kv = torch.einsum("bsn,bsh,bshp->bhnp", Bm.float(), dt, xh.float())
        state = torch.exp(da)[:, 0, :, None, None] * state + kv
        return torch.einsum("bsn,bhnp->bshp", Cm.float(), state), state

    if not isinstance(xh, DTensor):
        return run(xh, Bm, Cm, da, dt, state)
    mesh = xh.device_mesh
    b, _, m, _ = sh.resolve_spec(mesh, ("batch", None, "model", None),
                                 xh.shape)
    x_pl = sh.placements(mesh, (b, None, m, None))
    n_pl = sh.placements(mesh, (b, None, None))
    h_pl = sh.placements(mesh, (b, None, m))
    s_pl = sh.placements(mesh, (b, m, None, None))
    n_grad = tuple(Partial() if a == "model" and m else pl
                   for a, pl in zip(mesh.mesh_dim_names, n_pl))
    s_in = None if state is None else s_pl
    return local_map(
        run, out_placements=(x_pl, s_pl),
        in_placements=(x_pl, n_pl, n_pl, h_pl, h_pl, s_in),
        in_grad_placements=(x_pl, n_grad, n_grad, h_pl, h_pl, s_in),
        device_mesh=mesh, redistribute_inputs=True)(xh, Bm, Cm, da, dt,
                                                    state)


def _mamba_block(cfg, p, x, rc, conv_prev=None, state=None):
    """Returns (x_out, new_conv_state, new_ssm_state).  The conv adds
    `conv_b` where the block has one (`cfg.conv_bias`), and the output
    joins x times `cfg.residual_mult` where that is not 1."""
    with trace.span("rt:mamba"):
        cdt = getattr(torch, rc.compute_dtype)
        d_in, H, P, N, conv_dim = _dims(cfg)
        B_, S, d = x.shape
        h = L.rms_norm(x, p["ln"], cfg.norm_eps)
        # its gradient gathers the slices' in its own layout before the
        # product's backward (they come back in layouts that mix badly)
        zxbcdt = L.grad_as_forward(h @ p["in_proj"].to(cdt))
        z = zxbcdt[..., :d_in]
        xbc = zxbcdt[..., d_in: d_in + conv_dim]
        dt_raw = zxbcdt[..., d_in + conv_dim:]
        xbc, conv_state = _conv1d(xbc, p["conv_w"].to(cdt), conv_prev)
        if "conv_b" in p:
            xbc = xbc + p["conv_b"].to(cdt)
        xbc = F.silu(xbc)
        xh = L.split_heads(xbc[..., :d_in], H, P)
        Bm = xbc[..., d_in: d_in + N]
        Cm = xbc[..., d_in + N:]
        dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
        a = -torch.exp(p["a_log"].float())                  # (H,)
        da = dt * a                                          # (B,S,H) f32
        chunk = next(c for c in (rc.ssm_chunk, 128, 64, 32, 16, 8, 4, 2, 1)
                     if c <= S and S % c == 0)
        with trace.span("rt:mamba.ssd"):
            y, state = _ssd(xh, Bm, Cm, da, dt, state, chunk, cdt)
        y = y.to(cdt) + p["skip_d"].to(cdt)[None, None, :, None] * xh
        y = L.merge_heads(y)
        y = y * F.silu(z)
        y = L.rms_norm(y, p["gn"], cfg.norm_eps)
        out = y @ p["out_proj"].to(cdt)
        return tfm._residual(cfg, x, out), conv_state, state


def _shared(params):
    """The shared block's parameters (views; gathered where used)."""
    return L.tree_map(lambda a: a[0], params["shared_attn"])


def forward(cfg: ModelConfig, params, batch, rc, return_cache=False):
    """Returns (x, 0, cache, None, 0): the cache holds each block's conv
    and SSM states ("conv"/"state" (ng, GROUP, ...), "tail_conv" /
    "tail_state") and each shared-attention application's K/V ("k"/"v"
    (ng, B, S, Hkv, Dh))."""
    cdt = getattr(torch, rc.compute_dtype)
    x = constrain(sh.unshard(params["embed"])[batch["tokens"]].to(cdt),
                  ("batch", None, None))
    shared = _shared(params)
    ng, tail = n_groups_tail(cfg)
    remat = rc.remat == "full" and torch.is_grad_enabled()

    def mamba(x, stacked, j):
        return _mamba_block(cfg, L.layer(stacked, j), x, rc)

    def blocks(x, stacked, n):
        """n Mamba2 blocks, each checkpointed under remat."""
        convs, states = [], []
        for j in range(n):
            x, cs, st = (checkpoint(mamba, x, stacked, j, use_reentrant=False)
                         if remat else mamba(x, stacked, j))
            convs.append(cs)
            states.append(st)
        return x, torch.stack(convs), torch.stack(states)

    def group(x, stacked, g):
        x, cs, st = blocks(x, L.tree_map(lambda a: a[g], stacked), GROUP)
        sa = L.gathered(shared)
        x, (k, v) = tfm.attn_block(cfg, sa["attn"], x, 0, 0, rc)
        x, _ = tfm.mlp_block(cfg, sa["mlp"], x, rc)
        return x, cs, st, k, v

    kept = []
    for g in range(ng):
        # the whole group again in the backward pass, its blocks one by one
        out = (checkpoint(group, x, params["mamba_groups"], g,
                          use_reentrant=False) if remat
               else group(x, params["mamba_groups"], g))
        x = out[0]
        if return_cache:
            kept.append(out[1:])
    if tail:
        x, tconv, tstate = blocks(x, params["mamba_tail"], tail)
    x = L.rms_norm(x, sh.unshard(params["final_ln"]), cfg.norm_eps)
    cache = None
    if return_cache:
        cs, st, k, v = (torch.stack(t) for t in zip(*kept))
        cache = {"conv": cs, "state": st, "k": k, "v": v}
        if tail:
            cache["tail_conv"], cache["tail_state"] = tconv, tstate
    return x, 0, cache, None, torch.zeros((), dtype=torch.float32,
                                          device=x.device)


def init_cache(cfg: ModelConfig, batch_size: int, seq_len: int, dtype):
    """{name: (shape, dtype)}: SSM states stay f32 whatever `dtype`."""
    d_in, H, P, N, conv_dim = _dims(cfg)
    ng, tail = n_groups_tail(cfg)
    W = cfg.conv_width
    c = {
        "conv": ((ng, GROUP, batch_size, W - 1, conv_dim), dtype),
        "state": ((ng, GROUP, batch_size, H, N, P), torch.float32),
        "k": ((ng, batch_size, seq_len, cfg.n_kv_heads, cfg.head_dim), dtype),
        "v": ((ng, batch_size, seq_len, cfg.n_kv_heads, cfg.head_dim), dtype),
    }
    if tail:
        c["tail_conv"] = ((tail, batch_size, W - 1, conv_dim), dtype)
        c["tail_state"] = ((tail, batch_size, H, N, P), torch.float32)
    return c


def cache_logical():
    return {"conv": (None, None, "batch", None, "model"),
            "state": (None, None, "batch", None, None, "model"),
            "k": (None, "batch", "batch2", "model", "model2"),
            "v": (None, "batch", "batch2", "model", "model2"),
            "tail_conv": (None, "batch", None, "model"),
            "tail_state": (None, "batch", None, None, "model")}


def decode(cfg: ModelConfig, params, cache, token, pos: int, rc):
    """One-token step: every block's conv and SSM state and the shared
    block's K/V advance in place.  Returns (logits (B,1,V), cache)."""
    cdt = getattr(torch, rc.compute_dtype)
    x = sh.unshard(params["embed"])[token].to(cdt)
    shared = L.gathered(_shared(params))
    ng, tail = n_groups_tail(cfg)

    def step(x, pl, conv, state):
        x, cs, st = _mamba_block(cfg, pl, x, rc, conv_prev=conv, state=state)
        conv.copy_(cs)
        state.copy_(st)
        return x

    for g in range(ng):
        for j in range(GROUP):
            pl = L.gathered(L.tree_map(lambda a: a[g, j],
                                       params["mamba_groups"]))
            x = step(x, pl, cache["conv"][g, j], cache["state"][g, j])
        x, _ = tfm.decode_attn_block(cfg, shared["attn"], x, 0,
                                     cache["k"][g], cache["v"][g], pos, rc)
        x, _ = tfm.mlp_block(cfg, shared["mlp"], x, rc)
    for j in range(tail):
        pl = L.layer(params["mamba_tail"], j)
        x = step(x, pl, cache["tail_conv"][j], cache["tail_state"][j])
    x = L.rms_norm(x, sh.unshard(params["final_ln"]), cfg.norm_eps)
    logits = x @ sh.unshard(params["lm_head"]).to(cdt)
    return constrain(logits, ("batch", None, "model")), cache
