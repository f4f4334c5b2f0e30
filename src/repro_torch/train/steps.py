"""Step builders: train_step / prefill_step / serve_step (decode).

The counterparts of `build_train_step`, `build_prefill_step`,
`build_serve_step` and `build_step` of `repro.train.steps`, as plain
callables on an explicit device.  PyTorch runs eagerly, so there is
nothing to lower: no ShapeDtypeStructs and no StepBundle.

With a mesh (a torch.distributed DeviceMesh of "data"/"model", and
"pod"), the step runs on DTensors: it expects the parameters, optimizer
state and caches placed by `param_specs` and `cache_specs`
(`layers.tree_distribute`), places each whole batch tensor it is handed
by `batch_specs`, and sets the ambient mesh of the model's constraints
for its duration.  Tensors the model makes itself (positions, masks,
zeros) count as replicated.  Without a mesh nothing of this runs.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)
from torch.utils.checkpoint import checkpoint

from repro_torch import trace
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig, RunConfig
from repro_torch.models.layers import (tree_get, tree_items, tree_map,
                                       tree_set)
from repro_torch.optim import adamw
from repro_torch.parallel import shardings as sh


# ----------------------------------------------------------------- batches

def batch_shapes(cfg: ModelConfig, rc: RunConfig, with_labels: bool):
    """{name: (shape, dtype)} of one global batch, as the reference's
    `batch_structs`: tokens (and labels) int32, with an encoder the stub
    frame embeddings and with a patch prefix the stub patch embeddings,
    both bfloat16; the lead is (nmb, B/nmb) with microbatches."""
    B, S = rc.global_batch, rc.seq_len
    nmb = rc.num_microbatches
    lead = (nmb, B // nmb) if nmb > 1 else (B,)
    out = {"tokens": ((*lead, S), torch.int32)}
    if with_labels:
        out["labels"] = ((*lead, S), torch.int32)
    if cfg.enc_layers:
        out["frames"] = ((*lead, cfg.enc_frames, cfg.d_model), torch.bfloat16)
    if cfg.n_patches:
        out["patches"] = ((*lead, cfg.n_patches, cfg.d_model),
                          torch.bfloat16)
    return out


def batch_logical(cfg: ModelConfig, rc: RunConfig, with_labels: bool):
    """{name: logical spec} of one global batch (`batch_shapes`)."""
    nmb = rc.num_microbatches
    lead = (None, "batch") if nmb > 1 else ("batch",)
    out = {"tokens": (*lead, None)}
    if with_labels:
        out["labels"] = (*lead, None)
    if cfg.enc_layers:
        out["frames"] = (*lead, None, None)
    if cfg.n_patches:
        out["patches"] = (*lead, None, None)
    return out


def batch_specs(cfg, rc, mesh, with_labels):
    """{name: PartitionSpec entries} of one global batch on `mesh`."""
    logical = batch_logical(cfg, rc, with_labels)
    return {name: sh.resolve_spec(mesh, logical[name], shape)
            for name, (shape, _) in batch_shapes(cfg, rc,
                                                 with_labels).items()}


def param_specs(cfg: ModelConfig, rc: RunConfig, mesh):
    """Parameter specs on `mesh`, honouring the RunConfig's fsdp policy
    (auto: on for training, and for serving when a model shard's
    parameters pass 3 GiB)."""
    defs = registry.param_defs(cfg)
    itemsize = getattr(torch, rc.param_dtype).itemsize
    msize = sh.axis_size(mesh, "model") if "model" in \
        mesh.mesh_dim_names else 1
    per_shard = sum(math.prod(d.shape) for _, d in L.tree_items(defs)) \
        * itemsize // max(1, msize)
    return L.tree_specs(defs, mesh, fsdp=rc.fsdp_enabled(per_shard))


def cache_specs(cfg: ModelConfig, mesh, shapes: dict):
    """{name: PartitionSpec entries} of a cache given {name: (shape,
    dtype)}."""
    logical = registry.cache_logical(cfg)
    return {name: sh.resolve_spec(mesh, logical[name], shape)
            for name, (shape, _) in shapes.items()}


@contextlib.contextmanager
def _on_mesh(mesh):
    """The ambient mesh of the model's constraints, with the tensors the
    model makes itself taken as replicated; nothing without a mesh."""
    if mesh is None:
        yield
        return
    with sh.ambient_mesh(mesh), implicit_replication():
        yield


def _place_batch(batch, dev, specs, mesh):
    """The batch on `dev`, each tensor placed by its spec under a mesh."""
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    if mesh is None:
        return batch
    return {k: v if isinstance(v, DTensor) else L.distribute(v, mesh,
                                                             specs[k])
            for k, v in batch.items()}


def _argmax(logits):
    """The next tokens (B,1) int32, over the whole vocabulary row."""
    logits = sh.constrain(logits, ("batch", None, None))
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _whole(t):
    """A 0-d metric whole on every rank."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_batch(cfg: ModelConfig, rc: RunConfig, generator: torch.Generator,
               with_labels=True):
    """A random batch on the generator's device: tokens uniform over the
    vocabulary, frames and patches standard normal (drawn in f32, then
    cast)."""
    dev = generator.device
    out = {}
    for name, (shape, dtype) in batch_shapes(cfg, rc, with_labels).items():
        if dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab, shape, generator=generator,
                                      device=dev, dtype=torch.int32)
        else:
            out[name] = torch.randn(shape, generator=generator, device=dev,
                                    dtype=torch.float32).to(dtype)
    return out


def _on(dev: torch.device, params):
    """Raise unless the parameters lie on `dev`."""
    got = params["embed"].device
    if got.type != dev.type or (dev.index is not None
                                and got.index != dev.index):
        raise ValueError(f"parameters lie on {got}, the step runs on {dev}")


# ----------------------------------------------------------------- loss

def _ce_terms(logits, labels):
    """lse - logit of the label, per token, in fp32."""
    if isinstance(logits, DTensor):
        return _ce_terms_sharded(logits, labels)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - ll


def _ce_terms_sharded(logits, labels):
    """`_ce_terms` on DTensors through `local_map`: each device takes its
    own batch rows and, where "model" splits the vocabulary over more
    than one device, its own slice of it; the row's max, sum of
    exponentials and label logit are then reduced over "model" (so the
    logits are never gathered, and the gather's backward meets no
    global-shape buffer, which DTensor's would make on every device).
    With the whole vocabulary on each device, the rows go through
    `_ce_terms` itself."""
    mesh = logits.device_mesh
    spec = sh.resolve_spec(mesh, ("batch", None, "model"), logits.shape)
    if spec[2] and sh.axis_size(mesh, "model") == 1:
        spec = (spec[0], None, None)
    rows, tok = sh.placements(mesh, spec), sh.placements(mesh, spec[:2])
    group = mesh["model"] if spec[2] else None

    def local(logits, labels):
        logits = logits.float()
        if group is None:
            return _ce_terms(logits, labels)
        v = logits.shape[-1]
        m = funcol.wait_tensor(funcol.all_reduce(
            logits.detach().amax(dim=-1), "max", group))
        total = sh.sum_over(torch.exp(logits - m[..., None]).sum(dim=-1),
                            group)
        idx = labels.long() - mesh.get_local_rank("model") * v
        mine = (idx >= 0) & (idx < v)
        picked = torch.gather(logits, -1, idx.clamp(0, v - 1)[..., None])
        ll = sh.sum_over(torch.where(mine, picked[..., 0], 0.0), group)
        return torch.log(total) + m - ll

    return local_map(local, out_placements=list(tok),
                     in_placements=(rows, tok), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def _ce(logits, labels):
    """Token-mean cross entropy in fp32. logits (B,S,V), labels (B,S).
    No ignore index: every label counts."""
    return torch.mean(_ce_terms(logits, labels))


def _ce_chunked(cfg, params, x, labels, rc):
    """Vocab peak-memory-bounded CE: a loop over sequence chunks, each
    chunk's logits recomputed in the backward. x (B,S,d)."""
    B, S, d = x.shape
    c = rc.chunked_ce
    if S % c:
        raise ValueError(f"chunked_ce={c} does not divide seq_len={S}")

    def body(xc, lc):
        logits = registry.unembed(cfg, params, xc, rc)
        return torch.sum(_ce_terms(logits, lc))

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // c):
        xc, lc = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        tot = tot + (checkpoint(body, xc, lc, use_reentrant=False)
                     if torch.is_grad_enabled() else body(xc, lc))
    return tot / (B * S)


def loss_fn(cfg: ModelConfig, params, batch, rc: RunConfig):
    x, prefix_len, _, _, aux = registry.forward(cfg, params, batch, rc)
    if prefix_len:
        x = x[:, prefix_len:]
    if rc.chunked_ce:
        loss = _ce_chunked(cfg, params, x, batch["labels"], rc)
    else:
        logits = registry.unembed(cfg, params, x, rc)
        loss = _ce(logits, batch["labels"])
    if cfg.is_moe:
        loss = loss + 0.01 * aux
    return loss


# ----------------------------------------------------------------- train

def _value_and_grad(cfg, rc, params, batch):
    """(loss, grads) of loss_fn with respect to every leaf of `params`;
    grads have each leaf's dtype."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    items = list(tree_items(leaves))
    with trace.span("rt:train.forward"):
        loss = loss_fn(cfg, leaves, batch, rc)
    with trace.span("rt:train.backward"):
        gs = torch.autograd.grad(loss, [t for _, t in items],
                                 allow_unused=True)
    grads: dict = {}
    for (path, t), g in zip(items, gs):
        if g is None:
            g = torch.zeros_like(t)
        elif isinstance(g, DTensor) and g.placements != t.placements:
            # a partial sum over the devices, reduced to the placements
            # of its parameter (and of the moments it updates)
            g = g.redistribute(t.device_mesh, t.placements)
        tree_set(grads, path, g)
    return loss.detach(), grads


def build_train_step(cfg: ModelConfig, rc: RunConfig,
                     opt: adamw.AdamWConfig | None = None, device="cuda",
                     mesh=None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    batch: tokens and labels (B,S), or (nmb, B/nmb, S) with
    num_microbatches > 1.  Parameters and moments are updated in place;
    metrics are {"loss", "grad_norm"} (the norm before clipping) as 0-d
    f32 tensors, whole on every rank under a mesh."""
    opt = opt or adamw.AdamWConfig()
    dev = resolve_device(device)
    bspecs = batch_specs(cfg, rc, mesh, True) if mesh is not None else None
    nmb = rc.num_microbatches
    gr_dt = getattr(torch, rc.grad_reduce_dtype)
    cdt = getattr(torch, rc.compute_dtype)

    def cast_once(params):
        """Mixed precision: ONE f32->bf16 cast per step, so that the
        gradients are taken (and reduced) in bf16."""
        if gr_dt == torch.float32:
            return params
        with trace.span("rt:train.cast"):
            return tree_map(
                lambda p: p.to(cdt) if p.dtype == torch.float32 else p,
                params)

    def step(params, opt_state, batch):
        _on(dev, params)
        batch = _place_batch(batch, dev, bspecs, mesh)
        with _on_mesh(mesh):
            return train(params, opt_state, batch)

    def train(params, opt_state, batch):
        if nmb == 1:
            loss, grads = _value_and_grad(cfg, rc, cast_once(params), batch)
        else:
            cparams = cast_once(params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = None
            with L.loop("microbatches", nmb) as trips:
                for i in range(trips):
                    l, g = _value_and_grad(cfg, rc, cparams,
                                           {k: v[i] for k, v in batch.items()})
                    with trace.span("rt:train.accumulate"):
                        loss = loss + l
                        if grads is None:           # 0 + g, in f32
                            grads = tree_map(lambda t: t.float(), g)
                        else:
                            for path, acc in tree_items(grads):
                                acc.add_(tree_get(g, path).float())
                    del g
            with trace.span("rt:train.accumulate"):
                loss = loss / nmb
                grads = tree_map(lambda t: t.div_(nmb), grads)
        with trace.span("rt:optim.adamw"):
            new_params, new_opt, gnorm = adamw.apply_updates(
                opt, params, grads, opt_state)
        return new_params, new_opt, {"loss": _whole(loss),
                                     "grad_norm": _whole(gnorm)}

    return step


# ----------------------------------------------------------------- prefill

def build_prefill_step(cfg: ModelConfig, rc: RunConfig, device="cuda",
                       mesh=None):
    """step(params, batch) -> (next_tok (B,1) int32, cache).

    Runs the full-sequence forward over batch["tokens"] (B,S) (and the
    batch's frames or patches), keeping the family's cache (a transformer
    keeps each layer's K/V over S + n_patches positions and, with an
    encoder, its cross K/V), and takes the argmax of the last position's
    logits.  Under a mesh the cache comes out placed by `cache_specs`
    and the tokens sharded over the batch."""
    dev = resolve_device(device)
    bspecs = batch_specs(cfg, rc, mesh, False) if mesh is not None else None

    def step(params, batch):
        _on(dev, params)
        batch = _place_batch(batch, dev, bspecs, mesh)
        with torch.no_grad(), _on_mesh(mesh):
            with trace.span("rt:prefill.forward"):
                x, _, cache, _, _ = registry.forward(cfg, params, batch, rc,
                                                     return_cache=True)
            with trace.span("rt:prefill.head"):
                logits = registry.unembed(cfg, params, x[:, -1:], rc)
                next_tok = _argmax(logits)
            if mesh is not None:
                specs = cache_specs(cfg, mesh, {k: (v.shape, v.dtype)
                                                for k, v in cache.items()})
                cache = {k: v.redistribute(mesh, sh.placements(mesh,
                                                               specs[k]))
                         for k, v in cache.items()}
                next_tok = sh.constrain(next_tok, ("batch", None))
        return next_tok, cache

    return step


def decode_shapes(cfg: ModelConfig, rc: RunConfig):
    """{name: (shape, dtype)} of the serve step's cache for
    rc.global_batch sequences, as the reference's `decode_cache_structs`:
    seq_len (+ n_patches for a transformer) positions, in the compute
    dtype (the recurrent states in f32), ring-buffered local layers with
    `rc.windowed_cache`."""
    S = rc.seq_len + (cfg.n_patches if cfg.family == "transformer" else 0)
    return registry.init_cache(cfg, rc.global_batch, S,
                               getattr(torch, rc.compute_dtype),
                               windowed=rc.windowed_cache)


def decode_cache(cfg: ModelConfig, rc: RunConfig, device="cuda", mesh=None):
    """The serve step's zero cache (`decode_shapes`), placed by
    `cache_specs` under a mesh."""
    dev = resolve_device(device)
    shapes = decode_shapes(cfg, rc)
    cache = {k: torch.zeros(shape, dtype=dt, device=dev)
             for k, (shape, dt) in shapes.items()}
    if mesh is None:
        return cache
    specs = cache_specs(cfg, mesh, shapes)
    return {k: L.distribute(v, mesh, specs[k]) for k, v in cache.items()}


def build_serve_step(cfg: ModelConfig, rc: RunConfig, device="cuda",
                     mesh=None):
    """step(params, cache, token (B,1), pos) -> (next_tok (B,1) int32,
    cache): one-token decode against a cache from `decode_cache` (or a
    prefill's), written in place.  Under a mesh the cache is placed by
    `cache_specs` and the tokens are sharded over the batch."""
    dev = resolve_device(device)

    def step(params, cache, token, pos):
        _on(dev, params)
        token = torch.as_tensor(token, device=dev)
        if mesh is not None and not isinstance(token, DTensor):
            token = L.distribute(token, mesh, sh.resolve_spec(
                mesh, ("batch", None), token.shape))
        with torch.no_grad(), _on_mesh(mesh):
            logits, cache = registry.decode(cfg, params, cache, token,
                                            int(pos), rc)
            next_tok = _argmax(logits)
        return next_tok, cache

    return step


def build_step(cfg: ModelConfig, rc: RunConfig, device="cuda", mesh=None):
    if rc.kind == "train":
        return build_train_step(cfg, rc, device=device, mesh=mesh)
    if rc.kind == "prefill":
        return build_prefill_step(cfg, rc, device=device, mesh=mesh)
    if rc.kind == "decode":
        return build_serve_step(cfg, rc, device=device, mesh=mesh)
    raise ValueError(rc.kind)
