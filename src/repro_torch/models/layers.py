"""Shared layers + parameter-definition infrastructure.

Every model builds a nested dict of ParamDef (shape, logical spec, init);
`tree_init` turns it into real tensors from an explicit torch.Generator
on the generator's device, `tree_specs` into the PartitionSpec entries
of each leaf on a mesh (the FSDP policy included) and `tree_distribute`
places real tensors by them as DTensors.

The layers compute what `repro.models.layers` computes: rms_norm scales
by (1 + w), RoPE rotates split halves, gelu is the tanh approximation,
masked logits are -1e30 and probabilities are cast to the compute dtype
before the PV product.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch.parallel import shardings as sh


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple  # logical axis per dim: "model" | "batch" | None
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0


def tree_items(tree, path=()):
    """(key path, leaf) pairs of a nested dict, keys in sorted order (the
    order in which JAX flattens a dict)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_items(tree[key], path + (key,))
    else:
        yield path, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def tree_get(tree, path):
    """The leaf at key path `path`."""
    for key in path:
        tree = tree[key]
    return tree


def layer(stacked, i: int):
    """Layer i's parameters: views into the stacked tensors, each gathered
    to its compute placements under a mesh (`shardings.unshard`).  Call it
    inside the remat region, so that the backward gathers again instead of
    keeping every layer's gathered weights."""
    return tree_map(lambda a: sh.unshard(a[i]), stacked)


def gathered(tree):
    """Every leaf of `tree` at its compute placements (`shardings.
    unshard`)."""
    return tree_map(sh.unshard, tree)


class _GradAsForward(torch.autograd.Function):
    """Identity on a DTensor whose gradient is put back in the forward
    value's placements: the backward of a head split or merge reshapes
    the gradient, which it can only where the forward could."""

    @staticmethod
    def forward(ctx, t):
        # a partial sum's gradient is the same on every device
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def grad_as_forward(t):
    """t, whose gradient comes back in t's own placements when t is a
    DTensor (where the backward would otherwise meet a layout its next
    op does not take)."""
    return _GradAsForward.apply(t) if isinstance(t, DTensor) else t


def matmul(x, w):
    """x (..., k) @ w (k, n).  On a DTensor of more than two dims the
    fold to two dims is written out and its gradient comes back in the
    fold's own layout: DTensor's product backward may split the rows over
    the dp axes where the batch dim itself could not be split, and the
    unfold to (B, S) could not take that."""
    if not isinstance(x, DTensor) or x.dim() == 2:
        return x @ w
    y = grad_as_forward(x.reshape(-1, x.shape[-1])) @ w
    return y.reshape(*x.shape[:-1], y.shape[-1])


def split_heads(t, n: int, dh: int):
    """(..., n*dh) -> (..., n, dh).  A DTensor sharded over the feature dim
    is gathered there first unless every shard holds whole heads: DTensor
    cannot split a sharded dim unevenly (GSPMD shards the heads' inner dim
    instead)."""
    if isinstance(t, DTensor):
        last = t.dim() - 1
        mesh = t.device_mesh
        want = [Replicate() if isinstance(p, Shard) and p.dim == last
                and n % mesh.size(i) else p
                for i, p in enumerate(t.placements)]
        if want != list(t.placements):
            t = t.redistribute(mesh, want)
    return grad_as_forward(t.reshape(*t.shape[:-1], n, dh))


def merge_heads(t):
    """(..., n, dh) -> (..., n*dh).  A DTensor sharded over dh is gathered
    there first: merged under the head dim, its shards would interleave,
    a strided layout that not every DTensor op takes."""
    if isinstance(t, DTensor):
        last = t.dim() - 1
        want = [Replicate() if isinstance(p, Shard) and p.dim == last else p
                for p in t.placements]
        if want != list(t.placements):
            t = t.redistribute(t.device_mesh, want)
    return grad_as_forward(t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1]))


def tree_set(tree: dict, path, value):
    """Put `value` at key path `path`, making the dicts on the way."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


# Set by the cost counter (tools/hlo_cost.py) while it records: a context
# manager (name, trips) -> the number of trips to run.
LOOP_HOOK: list = [None]


@contextlib.contextmanager
def loop(name: str, n: int):
    """The trips to run of a Python loop of `n` trips, the counterpart of
    the reference's scan: `n`, or 1 while a cost counter that cuts loops
    records (it multiplies the one trip's counts by n; the loop's outputs
    are then the one trip's, repeated)."""
    hook = LOOP_HOOK[0]
    if hook is None:
        yield n
        return
    with hook(name, n) as trips:
        yield trips


def tree_specs(defs, mesh, fsdp: bool = False):
    """Each leaf's PartitionSpec entries (`shardings.resolve_spec`). With
    fsdp=True, each tensor additionally shards its largest still-replicated
    dim over the "data" axis (ZeRO-3 within a pod; replicated across pods).
    The model gathers a layer's parameters at its start (`shardings.
    unshard`, inside the remat region, so the recompute gathers again) and
    the backward reduce-scatters the gradients."""
    if not fsdp or "data" not in mesh.mesh_dim_names:
        return tree_map(lambda d: sh.resolve_spec(mesh, d.logical, d.shape),
                        defs)
    dsize = sh.axis_size(mesh, "data")

    def spec(d: ParamDef):
        base = list(sh.resolve_spec(mesh, d.logical, d.shape))
        cands = [(dim, i) for i, (dim, s) in enumerate(zip(d.shape, base))
                 if s is None and dim % dsize == 0 and dim >= dsize]
        if cands:
            _, i = max(cands)
            base[i] = "data"
        return tuple(base)

    return tree_map(spec, defs)


def distribute(t, mesh, spec):
    """A whole tensor, present alike on every rank, as a DTensor placed by
    `spec`: each rank keeps its own shard, nothing is sent."""
    return distribute_tensor(t, mesh, sh.placements(mesh, spec),
                             src_data_rank=None)


def tree_distribute(params, mesh, specs):
    """`distribute` over a tree of whole tensors and its tree of specs."""
    return {k: (tree_distribute(v, mesh, specs[k]) if isinstance(v, dict)
                else distribute(v, mesh, specs[k]))
            for k, v in params.items()}


def tree_full(tree):
    """A tree with every DTensor leaf gathered whole (a collective: every
    rank calls it), other leaves unchanged."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def tree_init(defs, generator: torch.Generator, dtype=torch.float32):
    """Real tensors for `defs` on the generator's device: zeros / ones, or
    normal with std scale / sqrt(fan_in), drawn in float32 in the sorted
    leaf order and cast to `dtype`."""
    device = generator.device
    out = {}
    for path, d in tree_items(defs):
        if d.init == "zeros":
            a = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            a = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = d.scale / math.sqrt(max(1, fan_in))
            a = torch.randn(d.shape, generator=generator, device=device,
                            dtype=torch.float32).mul_(std).to(dtype)
        tree_set(out, path, a)
    return out


# ---------------------------------------------------------------- layers

def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope(x, positions, theta: float):
    """x: (..., S, H, D) rotary over D; positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.arange(0, half, dtype=torch.float32, device=x.device)
    inv = theta ** (-freqs / half)  # float32; no host-to-device copy
    ang = positions[..., None].float() * inv  # (..., S, half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    sin = sin[..., None, :]  # broadcast over heads
    cos = cos[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def attention_scores(q, k, v, mask, dtype=torch.bfloat16, scale=None):
    """Reference (non-flash) attention. q:(B,Sq,H,D) k/v:(B,Sk,Hkv,D).

    GQA handled by reshaping q into (B,Sq,Hkv,G,D).  QK^T is taken in
    float32 (bf16 products are exact there), then divided by sqrt(D), or
    times `scale` where one is given.  DTensors go through
    `_sharded_attention`."""
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, mask, dtype, scale)
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits / math.sqrt(D) if scale is None else logits * scale
    keep = mask[:, None, None, :, :] if mask.dim() == 3 else mask
    logits = logits.masked_fill(~keep, -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    common = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(common), v.to(common))
    return out.reshape(B, Sq, H, D)


def _sharded_attention(q, k, v, mask, dtype, scale=None):
    """`attention_scores` on DTensors through `local_map`: each device
    takes its own batch rows over the dp axes and its own query heads over
    "model".  Where the model axis divides the query heads but not the KV
    heads, each device holds every KV head and gives each of its query
    heads a copy of its own (DTensor cannot view the sharded heads as
    (Hkv, G)); the KV gradients are then partial sums over "model"."""
    mesh = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    lg = ("batch", None, "model", None)
    q_spec = sh.resolve_spec(mesh, lg, q.shape)
    split_kv = q_spec[2] is not None and \
        sh.resolve_spec(mesh, lg, k.shape)[2] is None
    k_spec = (q_spec[0], None, None if split_kv else q_spec[2], None)
    qp, kp = sh.placements(mesh, q_spec), sh.placements(mesh, k_spec)
    kg = tuple(Partial() if split_kv and a == "model" else p
               for a, p in zip(mesh.mesh_dim_names, kp))
    mask = mask.full_tensor() if isinstance(mask, DTensor) else mask

    def local(q, k, v):
        if split_kv:
            h0 = mesh.get_local_rank("model") * q.shape[2]
            pick = slice(h0, h0 + q.shape[2])
            k = k.repeat_interleave(H // Hkv, dim=2)[:, :, pick]
            v = v.repeat_interleave(H // Hkv, dim=2)[:, :, pick]
        return attention_scores(q, k, v, mask, dtype, scale)

    # one output: its placements as a list (a tuple reads as several)
    return local_map(local, out_placements=list(qp),
                     in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kg, kg), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def causal_mask(Sq, Sk, window=0, prefix_len=0, q_offset=0, device=None):
    """(Sq, Sk) boolean mask. window>0 = sliding window; prefix bidirectional."""
    qp = torch.arange(Sq, device=device)[:, None] + q_offset
    kp = torch.arange(Sk, device=device)[None, :]
    m = kp <= qp
    if window > 0:
        m = m & ((qp - kp) < window)
    if prefix_len:
        both_prefix = (qp < prefix_len) & (kp < prefix_len)
        m = m | both_prefix
    return m


def decode_mask(Smax, pos: int, window=0, device=None):
    """(1, Smax) mask for one-token decode at position `pos` (inclusive)."""
    kp = torch.arange(Smax, device=device)[None, :]
    m = kp <= pos
    if window > 0:
        m = m & ((pos - kp) < window)
    return m
