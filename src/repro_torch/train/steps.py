"""Step builders: train_step / prefill_step / serve_step (decode).

The counterparts of `build_train_step`, `build_prefill_step`,
`build_serve_step` and `build_step` of `repro.train.steps`, as plain
callables on an explicit device.  PyTorch runs eagerly, so there is
nothing to lower: no ShapeDtypeStructs, no shardings, no StepBundle (the
dry-run tooling is ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import resolve_device
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig, RunConfig
from repro_torch.models.layers import (tree_get, tree_items, tree_map,
                                       tree_set)
from repro_torch.optim import adamw


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
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - ll


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
    loss = loss_fn(cfg, leaves, batch, rc)
    grads: dict = {}
    for (path, t), g in zip(items, torch.autograd.grad(
            loss, [t for _, t in items], allow_unused=True)):
        tree_set(grads, path, torch.zeros_like(t) if g is None else g)
    return loss.detach(), grads


def build_train_step(cfg: ModelConfig, rc: RunConfig,
                     opt: adamw.AdamWConfig | None = None, device="cuda"):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    batch: tokens and labels (B,S), or (nmb, B/nmb, S) with
    num_microbatches > 1.  Parameters and moments are updated in place;
    metrics are {"loss", "grad_norm"} (the norm before clipping) as 0-d
    f32 tensors."""
    opt = opt or adamw.AdamWConfig()
    dev = resolve_device(device)
    nmb = rc.num_microbatches
    gr_dt = getattr(torch, rc.grad_reduce_dtype)
    cdt = getattr(torch, rc.compute_dtype)

    def cast_once(params):
        """Mixed precision: ONE f32->bf16 cast per step, so that the
        gradients are taken (and reduced) in bf16."""
        if gr_dt == torch.float32:
            return params
        return tree_map(
            lambda p: p.to(cdt) if p.dtype == torch.float32 else p, params)

    def step(params, opt_state, batch):
        _on(dev, params)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if nmb == 1:
            loss, grads = _value_and_grad(cfg, rc, cast_once(params), batch)
        else:
            cparams = cast_once(params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = None
            for i in range(nmb):
                l, g = _value_and_grad(cfg, rc, cparams,
                                       {k: v[i] for k, v in batch.items()})
                loss = loss + l
                if grads is None:           # 0 + g, in f32
                    grads = tree_map(lambda t: t.float(), g)
                else:
                    for path, acc in tree_items(grads):
                        acc.add_(tree_get(g, path).float())
                del g
            loss = loss / nmb
            grads = tree_map(lambda t: t.div_(nmb), grads)
        new_params, new_opt, gnorm = adamw.apply_updates(
            opt, params, grads, opt_state)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return step


# ----------------------------------------------------------------- prefill

def build_prefill_step(cfg: ModelConfig, rc: RunConfig, device="cuda"):
    """step(params, batch) -> (next_tok (B,1) int32, cache).

    Runs the full-sequence forward over batch["tokens"] (B,S) (and the
    batch's frames or patches), keeping the family's cache (a transformer
    keeps each layer's K/V over S + n_patches positions and, with an
    encoder, its cross K/V), and takes the argmax of the last position's
    logits."""
    dev = resolve_device(device)

    def step(params, batch):
        _on(dev, params)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad():
            x, _, cache, _, _ = registry.forward(cfg, params, batch, rc,
                                                 return_cache=True)
            logits = registry.unembed(cfg, params, x[:, -1:], rc)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache

    return step


def decode_cache(cfg: ModelConfig, rc: RunConfig, device="cuda"):
    """The serve step's zero cache for rc.global_batch sequences, as the
    reference's `decode_cache_structs`: seq_len (+ n_patches for a
    transformer) positions, in the compute dtype (the recurrent states in
    f32), ring-buffered local layers with `rc.windowed_cache`."""
    dev = resolve_device(device)
    S = rc.seq_len + (cfg.n_patches if cfg.family == "transformer" else 0)
    spec = registry.init_cache(cfg, rc.global_batch, S,
                               getattr(torch, rc.compute_dtype),
                               windowed=rc.windowed_cache)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in spec.items()}


def build_serve_step(cfg: ModelConfig, rc: RunConfig, device="cuda"):
    """step(params, cache, token (B,1), pos) -> (next_tok (B,1) int32,
    cache): one-token decode against a cache from `decode_cache` (or a
    prefill's), written in place."""
    dev = resolve_device(device)

    def step(params, cache, token, pos):
        _on(dev, params)
        token = torch.as_tensor(token, device=dev)
        with torch.no_grad():
            logits, cache = registry.decode(cfg, params, cache, token,
                                            int(pos), rc)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache

    return step


def build_step(cfg: ModelConfig, rc: RunConfig, device="cuda"):
    if rc.kind == "train":
        return build_train_step(cfg, rc, device=device)
    if rc.kind == "prefill":
        return build_prefill_step(cfg, rc, device=device)
    if rc.kind == "decode":
        return build_serve_step(cfg, rc, device=device)
    raise ValueError(rc.kind)
