"""Logical->physical sharding resolution: `repro.parallel.shardings` on a
torch.distributed DeviceMesh, with DTensor placements for the
reference's NamedShardings.

Logical axis names used by model code:
  "batch"  -> data-parallel axes ("pod","data") when present
  "model"  -> tensor/expert-parallel axis ("model",)
  None     -> replicated

Resolution is divisibility-aware: a dim is only sharded if the mesh axis
product divides it.  `resolve_spec` returns the entries of the
reference's PartitionSpec as a tuple (None, an axis name, or a tuple of
names); `placements` turns it into one DTensor placement per mesh dim.
A tensor dim over ("pod", "data") is Shard(i) on both mesh dims, pod
first: the row-major split that JAX's P(("pod", "data")) makes.

`constrain` is the reference's with_sharding_constraint: a redistribute
of a DTensor against the ambient mesh.  A plain tensor (single-device
runs, or the local pieces inside `local_map`) passes unchanged, as the
reference's constraint does outside a mesh.  `unshard` is the FSDP
gather of a parameter to the placements it computes in.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    names = mesh.mesh_dim_names
    return math.prod(mesh.shape[names.index(a)] for a in axes)


def resolve_spec(mesh, logical: Sequence, shape: Sequence[int]) -> tuple:
    """Map a logical spec (tuple of "batch"/"model"/"model2"/"batch2"/None
    per dim) to PartitionSpec entries, dropping entries whose mesh size
    does not divide the dim.

    "model2" is a *fallback* model-axis slot: it shards over "model" only if
    no earlier dim claimed the model axis (used e.g. to shard KV-cache
    head_dim when n_kv_heads is not divisible by the model axis).
    "batch2" takes the dp axes only if no "batch" dim could."""
    names = mesh.mesh_dim_names
    out = []
    model_used = False
    batch_used = False
    deferred_batch2 = []
    for i, (dim, name) in enumerate(zip(shape, logical)):
        if name is None:
            out.append(None)
            continue
        if name in ("model", "model2"):
            # the model axis can be claimed by at most one dim
            if model_used:
                out.append(None)
                continue
            name = "model"
        if name == "batch2":
            deferred_batch2.append((i, dim))
            out.append(None)
            continue
        axes = dp_axes(mesh) if name == "batch" else ("model",)
        axes = tuple(a for a in axes if a in names)
        if axes and dim % axis_size(mesh, axes) == 0:
            if name == "model":
                model_used = True
            if name == "batch":
                batch_used = True
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    if deferred_batch2 and not batch_used:
        axes = dp_axes(mesh)
        for i, dim in deferred_batch2:
            if axes and dim % axis_size(mesh, axes) == 0:
                out[i] = axes if len(axes) > 1 else axes[0]
                break
    return tuple(out)


def placements(mesh, spec: Sequence) -> tuple:
    """One placement per mesh dim: Shard(i) where tensor dim i's entry
    names that mesh dim, else Replicate()."""
    owner = {}
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            owner[a] = i
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.mesh_dim_names)


def named(mesh, logical: Sequence, shape: Sequence[int]):
    """(mesh, placements): the counterpart of the reference's
    NamedSharding."""
    return mesh, placements(mesh, resolve_spec(mesh, logical, shape))


def constrain(x, logical: Sequence):
    """Redistribute a DTensor to the placements of `logical` on the
    ambient mesh, divisibility-aware.  Safe outside a mesh: a plain
    tensor, or any tensor while no mesh is set, comes back unchanged."""
    mesh = _MESH[0]
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = placements(mesh, resolve_spec(mesh, logical, x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def unshard(x):
    """A parameter's compute placements: a DTensor's shards over the dp
    mesh dims (its FSDP shard) gathered, the "model" shards kept.  The
    backward of the gather reduce-scatters the gradient.  A plain tensor
    comes back unchanged."""
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    dp = dp_axes(x.device_mesh)
    want = tuple(Replicate() if names[i] in dp else p
                 for i, p in enumerate(x.placements))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


class _SumOver(torch.autograd.Function):
    """All-reduce sum over a mesh dim; the gradient passes unchanged (the
    sum's consumers are replicated over that dim, so each device already
    holds the whole gradient)."""

    @staticmethod
    def forward(ctx, t, group):
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOver(torch.autograd.Function):
    """All-reduce mean over a mesh dim; each input's gradient is the
    (replicated) gradient over the dim's size."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.n = group.size()
        return funcol.wait_tensor(funcol.all_reduce(t, "avg", group))

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def sum_over(t, group):
    """Inside `local_map`: the sum of a local tensor over the devices of
    `group` (a 1-D mesh), for consumers replicated over it."""
    return _SumOver.apply(t, group)


def mean_over(t, group):
    """Inside `local_map`: the mean of a local tensor over `group`."""
    return _MeanOver.apply(t, group)


# The trainer and the `build_*_step` steps set this around a step so the
# model-internal constraints resolve against the right mesh.
_MESH: list = [None]


def set_ambient_mesh(mesh) -> None:
    _MESH[0] = mesh


def get_ambient_mesh():
    return _MESH[0]


@contextlib.contextmanager
def ambient_mesh(mesh):
    """The ambient mesh set to `mesh` for the block, then restored."""
    prev = _MESH[0]
    _MESH[0] = mesh
    try:
        yield mesh
    finally:
        _MESH[0] = prev
