"""Plain training steps of the MoE model on batches read from the token
file, in the precision of `prec`, and the data order they follow.

  * data: the corpus is `n_seqs` rows of `seq_len` int32 tokens, uniform
    over the vocabulary, drawn 256 rows at a time from NumPy's
    default_rng(seed); step s
    of epoch e = s // (n_seqs // batch) takes the rows
    permutation(seed, e)[w * batch:(w + 1) * batch] (w = s mod the steps
    an epoch), sorted, of NumPy's default_rng((seed, e)); labels are
    the tokens shifted left by one, the last 0;
  * loss: the mean token cross entropy in float32 plus 0.01 times the
    layers' summed load-balance loss; the batch is split into
    `microbatches` equal parts and the gradients averaged;
  * AdamW: learning rate lr * min(1, (t + 1) / warmup) at step t (from
    0), gradients scaled by min(1, clip / (norm + 1e-12)), bias-corrected
    moments, decoupled weight decay on every leaf:
    p -= lr (m^ / (sqrt(v^) + eps) + wd p).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from chipbench.ref import flat, models


def corpus(seed: int, n_seqs: int, seq_len: int, vocab: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, vocab, (min(256, n_seqs - s),
                                                   seq_len), dtype=np.int32)
                           for s in range(0, n_seqs, 256)])


def rows_for(step: int, n_seqs: int, batch: int, seed: int):
    import numpy as np
    epoch, within = divmod(step, n_seqs // batch)
    perm = np.random.default_rng((seed, epoch)).permutation(n_seqs)
    return np.sort(perm[within * batch:(within + 1) * batch])


def batch(corpus: torch.Tensor, step: int, train: dict, seed: int):
    """(tokens, labels) (B, S) of `step` from the corpus (n_seqs, S)."""
    idx = rows_for(step, corpus.shape[0], train["batch"], seed)
    toks = corpus[torch.as_tensor(idx, device=corpus.device)]
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = 0
    return toks, labels


def loss(W, cfg, toks, labels, prec):
    x, aux, _ = models.phimoe_hidden(W, cfg, toks, prec)
    x = models.rms(x, W["final_ln"], cfg["rms_norm_eps"])
    logits = prec.mm(x.reshape(-1, x.shape[-1]), W["lm_head"])
    return F.cross_entropy(logits, labels.reshape(-1).long()) + 0.01 * aux


def grads(W, cfg, toks, labels, micro: int, prec):
    """(loss, {leaf: gradient}) averaged over the microbatches."""
    leaves = dict(flat(W))
    for t in leaves.values():
        t.requires_grad_(True)
    total, acc = 0.0, None
    n = toks.shape[0] // micro
    for i in range(micro):
        sl = slice(i * n, (i + 1) * n)
        lo = loss(W, cfg, toks[sl], labels[sl], prec)
        g = torch.autograd.grad(lo, list(leaves.values()))
        total += float(lo.detach()) / micro
        if acc is None:
            acc = [gi / micro for gi in g]
        else:
            for a, gi in zip(acc, g):
                a.add_(gi / micro)
        del g, lo
    for t in leaves.values():
        t.requires_grad_(False)
    return total, dict(zip(leaves, acc))


@torch.no_grad()
def adamw(W, g: dict, state: dict, opt: dict) -> float:
    """One step in place; returns the gradient's norm before clipping."""
    t = state["t"]
    lr = opt["lr"] * min(1.0, (t + 1) / max(1, opt["warmup_steps"]))
    norm = float(torch.sqrt(sum((x.double() ** 2).sum() for x in g.values())))
    scale = min(1.0, opt["grad_clip"] / (norm + 1e-12))
    b1, b2 = opt["b1"], opt["b2"]
    state["t"] = t = t + 1
    for name, p in flat(W):
        gi = g[name] * scale
        m = state["m"].setdefault(name, torch.zeros_like(p))
        v = state["v"].setdefault(name, torch.zeros_like(p))
        m.mul_(b1).add_(gi, alpha=1 - b1)
        v.mul_(b2).add_(gi * gi, alpha=1 - b2)
        mh, vh = m / (1 - b1 ** t), v / (1 - b2 ** t)
        p.sub_(lr * (mh / (vh.sqrt() + opt["eps"]) + opt["weight_decay"] * p))
    return norm
