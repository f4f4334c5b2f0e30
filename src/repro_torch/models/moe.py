"""Top-k MoE FFN with sort-based, capacity-bounded dispatch:
`repro.models.moe` in PyTorch.

Dispatch is a stable sort of the (token, slot) assignments by expert and
a scatter into an (E, C, d) buffer, so the expert products are dense
batched GEMMs over the active tokens only.  Assignments past an expert's
capacity C go to one drop slot (row E*C), which is thrown away.

Two dispatch strategies, as in the reference:
  * global: one logical (E, C, d) buffer.  Under a mesh the routing
    indices and the buffer are built on replicated tensors inside
    `local_map` (DTensor has no sharding rule that keeps the counts'
    scatter-add or the buffer's `index_put` local), the expert products
    run on the buffer sharded over "model", and the combine runs
    replicated again;
  * shard-local (`moe_ffn_sharded`, under `rc.shard_moe_tokens` with a
    mesh whose "model" axis divides the experts): each device routes its
    LOCAL tokens to its LOCAL experts inside `local_map`, and an
    all-reduce over "model" sums the partial outputs: no token moves and
    the buffer is (E/mp, C_l, d), C_l from the local token count.

On the card, a bf16 or fp16 forward without gradients (a prefill) moves
the rows through `kernels.moe_rows` instead of `_scatter` and
`_combine`: the same buffer, and each token's slots summed in slot order
(`moe_rows.route` names why a layer takes the plain functions).

What the port does differently, and why:
  * the combine (the reference's `.at[tok].add`) puts each assignment
    back in (token, slot) order through the inverse permutation and sums
    the top_k slots: no scatter-add, so no atomics on the card, and two
    runs (or a remat recompute and its forward) give the same bits;
  * the gather of the tokens reads an expanded (T*top_k, d) view through
    the permutation `order`, so its gradient is a sum over slots, not a
    scatter-add with repeated indices;
  * `torch.topk` makes no promise on ties where `jax.lax.top_k` takes the
    lower index first: the two route alike on probabilities without
    exact ties.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch import trace
from repro_torch.kernels import moe_rows
from repro_torch.parallel import shardings as sh
from repro_torch.parallel.shardings import constrain


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert: n_tokens * top_k / n_experts * capacity_factor,
    truncated as a Python float, rounded up to a multiple of 8, at least
    8 (the reference's arithmetic exactly)."""
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def moe_ffn(cfg, p, x, rc):
    """x: (T, d) -> (T, d), aux load-balance loss (scalar).  With
    `cfg.d_ff_shared`, a shared SwiGLU expert over every token is added
    to the routed experts' sum."""
    with trace.span("rt:moe"):
        y, aux = _routed(cfg, p, x, rc)
        if cfg.d_ff_shared:
            with trace.span("rt:moe.shared"):
                y = y + _shared_expert(p, x, getattr(torch, rc.compute_dtype))
        return y, aux


def _routed(cfg, p, x, rc):
    if rc.shard_moe_tokens:
        mesh = sh.get_ambient_mesh()
        if mesh is not None and "model" in mesh.mesh_dim_names \
                and cfg.n_experts % sh.axis_size(mesh, "model") == 0:
            return moe_ffn_sharded(cfg, p, x, rc, mesh)
    return _moe_ffn_global(cfg, p, x, rc)


def _shared_expert(p, x, cdt):
    """The shared expert's SwiGLU over every token of x (T, d)."""
    x = x.to(cdt)
    g = x @ p["shared_wg"].to(cdt)
    u = x @ p["shared_wu"].to(cdt)
    return (F.silu(g) * u) @ p["shared_wd"].to(cdt)


def route(cfg, p, x):
    """Router in f32.  Returns (top_p (T,k) renormalised, top_e (T,k)
    descending, aux): aux = E * sum(me * ce), where ce (the share of
    tokens whose first choice is each expert) carries no gradient."""
    E, k = cfg.n_experts, cfg.top_k
    gates = x.float() @ p["router"].float()                 # (T, E)
    probs = torch.softmax(gates, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(top_e[:, 0], E).float(), dim=0)
    return top_p, top_e, E * torch.sum(me * ce)


def _count(idx, n: int):
    """How many times each of 0..n-1 occurs in `idx` (the reference's
    `.at[idx].add(1)`; bincount's output length depends on the values, so
    it cannot run on fake tensors)."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def dispatch(cfg, top_e, C: int):
    """The sort-based dispatch of the (T*k,) assignments.  Returns (order,
    dest, keep): `order` sorts the assignments by expert (stable),
    `dest[i]` is the buffer row of sorted assignment i (E*C, the drop
    slot, when its expert is full) and `keep` says which were kept."""
    E = cfg.n_experts
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _count(flat_e, E)
    starts = torch.cumsum(counts, dim=0) - counts
    pos_in_e = torch.arange(flat_e.numel(), device=top_e.device) - \
        starts[sorted_e]
    keep = pos_in_e < C
    dest = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    return order, dest, keep


def _replicated(fn, n_out: int, *args):
    """fn(*args) -> n_out tensors, on whole tensors.  On DTensors each
    argument is gathered whole on every device (`local_map` with
    Replicate in and out), so every device computes the same results and
    the gradients are Replicate too."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    rep = tuple(Replicate() for _ in mesh.mesh_dim_names)
    ins = tuple(rep if isinstance(a, torch.Tensor) else None for a in args)
    # one output's placements are a list: a tuple would be read as the
    # placements of several outputs
    return local_map(fn, out_placements=list(rep) if n_out == 1
                     else (rep,) * n_out,
                     in_placements=ins, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _scatter(x, order, dest, n_experts: int, C: int, k: int, cdt):
    """The (n_experts, C, d) expert buffer: sorted assignment i holds
    token order[i] // k at row dest[i] (row n_experts * C, the drop slot,
    is cut off).  The gather reads an expanded (T*k, d) view through the
    permutation, so its gradient is a sum over slots, not a scatter-add
    with repeated indices."""
    T, d = x.shape
    xs = x.to(cdt)[:, None].expand(T, k, d).reshape(T * k, d)[order]
    buf = torch.zeros((n_experts * C + 1, d), dtype=cdt, device=x.device)
    buf = buf.index_put((dest,), xs)        # the drop slot's rows collide
    return buf[:n_experts * C].reshape(n_experts, C, d)


def _combine(out, dest, order, top_p, k: int):
    """y (T, d): each (token, slot) assignment's expert output times its
    gate, put back in (token, slot) order through the inverse permutation
    and summed over the k slots (the drop slot reads a zero row)."""
    Eb, C, d = out.shape
    out_flat = torch.cat([out.reshape(Eb * C, d),
                          torch.zeros((1, d), dtype=out.dtype,
                                      device=out.device)])
    gathered = out_flat[dest]                                # (T*k, d)
    w = top_p.reshape(-1)[order].to(out.dtype)
    inv = torch.argsort(order)              # sorted position of each slot
    return (gathered * w[:, None])[inv].reshape(-1, k, d).sum(dim=1)


def _experts(p, xe, cdt, constrain_to=None):
    """SwiGLU over each expert's rows: xe (E_b, C, d) -> (E_b, C, d)."""
    c = constrain_to or (lambda t: t)
    g = torch.bmm(xe, p["wg"].to(cdt))
    u = torch.bmm(xe, p["wu"].to(cdt))
    h = c(F.silu(g) * u)
    return c(torch.bmm(h, p["wd"].to(cdt)))


def _moe_ffn_global(cfg, p, x, rc, stats=None):
    """With `stats`, its "dropped" is the number of (token, slot)
    assignments past their expert's capacity."""
    cdt = getattr(torch, rc.compute_dtype)
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)
    # keep tokens data-sharded through the (B,S)->(T,) reshape
    x = constrain(x, ("batch", None))
    with trace.span("rt:moe.route"):
        top_p, top_e, aux = route(cfg, p, x)

    rows = moe_rows.route(x, top_p, cdt) == "kernel"

    def scatter(x, top_e):
        order, dest, keep = dispatch(cfg, top_e, C)
        return _scatter(x, order, dest, E, C, k, cdt), order, dest, keep

    with trace.span("rt:moe.dispatch"):
        if rows:
            order, dest, keep = dispatch(cfg, top_e, C)
            xe, slot_row = moe_rows.dispatch_rows(x.to(cdt), order, dest, E,
                                                  C, k)
        else:
            xe, order, dest, keep = _replicated(scatter, 4, x, top_e)
    _fill(T * k, E * C, keep)
    if stats is not None:
        stats["dropped"] = int((~keep).sum())
    xe = constrain(xe, ("model", None, None))
    with trace.span("rt:moe.experts"):
        out = _experts(p, xe, cdt,
                       lambda t: constrain(t, ("model", None, None)))
    with trace.span("rt:moe.combine"):
        if rows:
            y = moe_rows.combine_rows(out, slot_row, top_p)
        else:
            y = _replicated(lambda out, dest, order, top_p:
                            _combine(out, dest, order, top_p, k),
                            1, out, dest, order, top_p)
    if rows:
        trace.add("moe.kernel", 1)
    elif x.device.type == "cuda":
        trace.add("moe.plain", 1)
    return y, aux


def _fill(assignments: int, slots: int, keep) -> None:
    """The tracer's counts of an expert buffer: the assignments routed,
    its rows and, on the device, the assignments kept in them."""
    trace.add("moe.assignments", assignments)
    trace.add("moe.slots", slots)
    trace.add_device("moe.kept", keep)


# ------------------------------------------------------------ shard-local

def _local_dispatch_ffn(cfg, rc, x_l, router, wg, wu, wd, e_off: int,
                        E_l: int):
    """Per-device MoE: route local tokens to this device's experts.
    Returns the partial output (sum over local experts), the local aux
    and the number of assignments to local experts that were dropped."""
    cdt = getattr(torch, rc.compute_dtype)
    T_l, d = x_l.shape
    k = cfg.top_k
    C = capacity(cfg, T_l)
    with trace.span("rt:moe.route"):
        top_p, top_e, aux = route(cfg, {"router": router}, x_l)

    with trace.span("rt:moe.dispatch"):
        flat_e = top_e.reshape(-1)
        mine = (flat_e >= e_off) & (flat_e < e_off + E_l)
        loc_e = torch.where(mine, flat_e - e_off,
                            torch.full_like(flat_e, E_l))  # E_l: drop bucket
        order = torch.argsort(loc_e, stable=True)
        sorted_e = loc_e[order]
        counts = _count(loc_e, E_l + 1)
        starts = torch.cumsum(counts, dim=0) - counts
        pos = torch.arange(T_l * k, device=x_l.device) - starts[sorted_e]
        keep = (pos < C) & (sorted_e < E_l)
        dest = torch.where(keep, sorted_e * C + pos,
                           torch.full_like(pos, E_l * C))
        xe = _scatter(x_l, order, dest, E_l, C, k, cdt)
    _fill(T_l * k, E_l * C, keep)
    with trace.span("rt:moe.experts"):
        out = _experts({"wg": wg, "wu": wu, "wd": wd}, xe, cdt)
    dropped = ((~keep) & (sorted_e < E_l)).sum()
    with trace.span("rt:moe.combine"):
        return _combine(out, dest, order, top_p, k), aux, dropped


def moe_ffn_sharded(cfg, p, x, rc, mesh, stats=None):
    """Shard-local dispatch: tokens stay put (sharded over the dp axes
    when those divide T), each device routes them to its E/mp experts of
    the "model" shard, and an all-reduce over "model" sums the partial
    outputs.  aux is averaged over "model", then over the dp axes.  Whole
    (plain) tensors are placed on `mesh` first.  With `stats`, its
    "dropped" is the number of (token, slot) assignments dropped over all
    devices."""
    names = mesh.mesh_dim_names
    mp = sh.axis_size(mesh, "model")
    E_l = cfg.n_experts // mp
    dp = sh.dp_axes(mesh)
    tok = dp if (dp and x.shape[0] % sh.axis_size(mesh, dp) == 0) else None
    x_pl = sh.placements(mesh, (tok, None))
    w_pl = sh.placements(mesh, ("model", None, None))
    rep = sh.placements(mesh, ())
    # gradients: each device's local dispatch gives a partial gradient of
    # its tokens (over "model") and of the shared router / its experts
    # (over the dp axes, when the tokens are split there)
    part = lambda a: Partial() if a == "model" or (tok and a in dp) \
        else Replicate()
    x_g = tuple(Partial() if a == "model" else pl
                for a, pl in zip(names, x_pl))
    r_g = tuple(part(a) for a in names)
    w_g = tuple(pl if a == "model" else part(a)
                for a, pl in zip(names, w_pl))
    groups = {a: mesh[a] for a in names}

    def local(x_l, router, wg, wu, wd):
        e_off = mesh.get_local_rank("model") * E_l
        y, aux, dropped = _local_dispatch_ffn(cfg, rc, x_l, router, wg, wu,
                                              wd, e_off, E_l)
        y = sh.sum_over(y, groups["model"])
        aux = sh.mean_over(aux, groups["model"])
        for a in (tok or ()):
            aux = sh.mean_over(aux, groups[a])
        # summed over the dims whose devices hold other experts or tokens
        for a in ("model", *(tok or ())):
            dropped = funcol.wait_tensor(
                funcol.all_reduce(dropped, "sum", groups[a]))
        return y, aux, dropped

    pls = (x_pl, rep, w_pl, w_pl, w_pl)
    args = [a if isinstance(a, DTensor) else
            distribute_tensor(a, mesh, pl_a, src_data_rank=None)
            for a, pl_a in zip((x, p["router"], p["wg"], p["wu"], p["wd"]),
                               pls)]
    y, aux, dropped = local_map(
        local, out_placements=(x_pl, rep, rep), in_placements=pls,
        in_grad_placements=(x_g, r_g, w_g, w_g, w_g), device_mesh=mesh,
        redistribute_inputs=True)(*args)
    if stats is not None:
        stats["dropped"] = int(dropped.full_tensor())
    return y, aux
