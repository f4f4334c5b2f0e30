"""Top-k MoE FFN with sort-based, capacity-bounded dispatch: the global
path of `repro.models.moe`.

Dispatch is a stable sort of the (token, slot) assignments by expert and
a scatter into an (E, C, d) buffer, so the expert products are dense
batched GEMMs over the active tokens only.  Assignments past an expert's
capacity C go to one drop slot (row E*C), which is thrown away.

The reference's shard-local dispatch (`moe_ffn_sharded`, shard_map over
the "model" mesh axis) needs a mesh; without one the reference takes this
global path even with `rc.shard_moe_tokens` set, and so does the port
(multi-device is ROADMAP Queue 1 item 6).

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
import torch.nn.functional as F


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert: n_tokens * top_k / n_experts * capacity_factor,
    truncated as a Python float, rounded up to a multiple of 8, at least
    8 (the reference's arithmetic exactly)."""
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def moe_ffn(cfg, p, x, rc):
    """x: (T, d) -> (T, d), aux load-balance loss (scalar)."""
    return _moe_ffn_global(cfg, p, x, rc)


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


def dispatch(cfg, top_e, C: int):
    """The sort-based dispatch of the (T*k,) assignments.  Returns (order,
    dest, keep): `order` sorts the assignments by expert (stable),
    `dest[i]` is the buffer row of sorted assignment i (E*C, the drop
    slot, when its expert is full) and `keep` says which were kept."""
    E = cfg.n_experts
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, dim=0) - counts
    pos_in_e = torch.arange(flat_e.numel(), device=top_e.device) - \
        starts[sorted_e]
    keep = pos_in_e < C
    dest = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    return order, dest, keep


def _moe_ffn_global(cfg, p, x, rc):
    cdt = getattr(torch, rc.compute_dtype)
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)
    top_p, top_e, aux = route(cfg, p, x)
    order, dest, _ = dispatch(cfg, top_e, C)

    # sorted assignment i reads token order[i] // k: the (T*k, d) expanded
    # view taken through the permutation
    xs = x.to(cdt)[:, None].expand(T, k, d).reshape(T * k, d)[order]
    buf = torch.zeros((E * C + 1, d), dtype=cdt, device=x.device)
    buf = buf.index_put((dest,), xs)        # the drop slot's rows collide
    xe = buf[:E * C].reshape(E, C, d)

    g = torch.bmm(xe, p["wg"].to(cdt))
    u = torch.bmm(xe, p["wu"].to(cdt))
    h = F.silu(g) * u
    out = torch.bmm(h, p["wd"].to(cdt))

    out_flat = torch.cat([out.reshape(E * C, d),
                          torch.zeros((1, d), dtype=cdt, device=x.device)])
    gathered = out_flat[dest]                                # (T*k, d)
    w = top_p.reshape(-1)[order].to(cdt)
    inv = torch.argsort(order)              # sorted position of each slot
    return (gathered * w[:, None])[inv].reshape(T, k, d).sum(dim=1), aux
