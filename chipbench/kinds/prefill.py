"""Prefill requests from one client in a closed loop, batch 1: the step of
`build_prefill_step` over each prompt, timed from its call to the next
token on the host after a synchronisation.

Checked after the window: a sample of the finished requests drawn from
the seed out of every round the window finished (`gen.Prompts.sample`),
with the longest among them.  The plain reference runs each sampled
prompt in float32, and the cell's limits file names which of these
numbers it compares.  Of a position's key and value in one layer, its
error is the larger of their relative errors there:
  gap          the widest amount by which a served token's logit lies
               below the reference's best logit at that position;
  kv_med       the median error over every layer and position of every
               sampled request: the cache carries every layer's
               attention, routing, expert and SSD output into the next;
  kv_layer_med the largest over the layers of a layer's median error
               over the sample's positions: a fault in a few layers;
  kv_tail_med  the median error over every layer and the second half of
               the longest request's positions: long keys;
  kv_err       the largest relative error of a layer's keys or values,
               over all its positions;
  state_err, conv_err  the largest relative error of a Mamba2 block's
               SSM state and conv window.
The last layer's attention and experts, the final norm and the head
reach the result only through the served token, which only `gap` covers.
"""
from __future__ import annotations

import torch

from chipbench import gen, ref, weights
from chipbench import models as bench_models
from chipbench.ref import models as ref_models


def _program_cache(cfg: dict, cache: dict) -> dict:
    """The step's cache as per-layer lists, in the reference's order."""
    if cfg["model_type"] == "zamba2":
        ng, grp = cache["conv"].shape[:2]
        conv = [cache["conv"][g, j, 0] for g in range(ng) for j in range(grp)]
        state = [cache["state"][g, j, 0] for g in range(ng)
                 for j in range(grp)]
        if "tail_conv" in cache:
            conv += list(cache["tail_conv"][:, 0])
            state += list(cache["tail_state"][:, 0])
        return {"conv": conv, "state": state,
                "k": list(cache["k"][:, 0]), "v": list(cache["v"][:, 0])}
    return {"k": list(cache["k"][:, 0]), "v": list(cache["v"][:, 0])}


def compare(cfg: dict, params, tokens, served, got: dict) -> dict:
    """The numbers of one request: the reference's gap for the served
    token (with `served` a tensor of one token a position, the control's,
    the gaps at every position) and the errors of the cache `got`
    (per-layer lists, as the reference keeps them) against the
    reference's."""
    every = torch.is_tensor(served)
    logits, rc = ref_models.FORWARD[cfg["model_type"]](
        params, cfg, tokens, ref.F32, every=every)
    if every:
        gaps = logits.max(-1).values - logits.gather(
            -1, served[:, None].long())[:, 0]
    else:
        gaps = (logits.max() - logits[served])[None]
    del logits
    out = {"gaps": gaps.double().cpu()}
    out["errs"] = torch.stack([
        torch.maximum(ref.token_err(gk, wk), ref.token_err(gv, wv))
        for gk, wk, gv, wv in zip(got["k"], rc["k"], got["v"], rc["v"])
    ]).cpu()                                    # (layers, positions)
    out["kv_err"] = max(ref.rel_err(g, w) for key in ("k", "v")
                        for g, w in zip(got[key], rc[key]))
    for key in ("state", "conv"):
        if key in got:
            out[f"{key}_err"] = max(ref.rel_err(g, w)
                                    for g, w in zip(got[key], rc[key]))
    return out


def pool(per_request, detail: bool = False) -> dict:
    """The sample's numbers from each request's; with `detail`, also the
    readings they are taken from (for `chipbench.calibrate`)."""
    out: dict = {}
    for got in per_request:
        for k, v in got.items():
            if not torch.is_tensor(v):
                out[k] = max(out.get(k, v), v)
    out["gap"] = max(float(g["gaps"].max()) for g in per_request)
    errs = torch.cat([g["errs"] for g in per_request], 1)
    out["kv_med"] = float(errs.median())
    out["kv_layer_med"] = float(errs.median(1).values.max())
    longest = max(per_request, key=lambda g: g["errs"].shape[1])["errs"]
    tail = longest[:, longest.shape[1] // 2:]
    out["kv_tail_med"] = float(tail.median())
    if detail:
        every = torch.cat([g["gaps"] for g in per_request])
        out["detail"] = {
            "lengths": [g["errs"].shape[1] for g in per_request],
            "last_gaps": [float(g["gaps"][-1]) for g in per_request],
            "gap_q50_q90_q99": every.quantile(
                torch.tensor([0.5, 0.9, 0.99], dtype=every.dtype)).tolist(),
            "layer_med": errs.median(1).values.tolist(),
            "tail_layer_med": tail.median(1).values.tolist()}
    return out


class Job:
    unit_name = "prefill"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg = cell.config
        self.kept: dict = {}

    def setup(self, warm: bool = True):
        from repro_torch.models import layers as L
        from repro_torch.models import registry
        from repro_torch.train import steps
        cfg = self.cfg
        self.mc = bench_models.model_config(cfg)
        self.rc = bench_models.prefill_run(cfg)
        defs = registry.param_defs(self.mc)
        leaves = [(p, tuple(d.shape), d.init) for p, d in L.tree_items(defs)]
        self.params = weights.make(leaves, cfg.get("init", []),
                                   getattr(torch, self.rc.param_dtype),
                                   self.seed, self.device)
        self.step = steps.build_prefill_step(self.mc, self.rc,
                                             device=self.device)
        self.prompts = gen.Prompts(self.cell.traffic, self.seed,
                                   cfg["vocab_size"], self.device)
        self.prompts.ensure(self.prompts.per_round)
        if warm:        # every length the traffic sends, the longest first
            for L_ in sorted(set(self.prompts.base), reverse=True):
                self._serve(self.prompts.lengths.index(L_))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.longest = None
        self.drawn: list = []       # (priority, index), the least first

    def _serve(self, i: int):
        next_tok, cache = self.step(self.params,
                                    {"tokens": self.prompts.tokens(i)})
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return int(next_tok[0, 0]), cache

    def _drop(self, i: int) -> None:
        if i != self.longest and all(j != i for _, j in self.drawn):
            self.kept.pop(i, None)

    def unit(self, i: int) -> dict:
        tok, cache = self._serve(i)
        L_ = self.prompts.lengths[i]
        # keep the caches of the sample drawn so far (`Prompts.sample`)
        # and of the longest request
        keep = False
        p = self.prompts.priority(i)
        k = self.cell.traffic["sample"]
        if len(self.drawn) < k or p < self.drawn[-1][0]:
            self.drawn = sorted(self.drawn + [(p, i)])
            keep = True
            if len(self.drawn) > k:
                self._drop(self.drawn.pop()[1])
        if self.longest is None or L_ > self.prompts.lengths[self.longest]:
            old, self.longest = self.longest, i
            keep = True
            if old is not None:
                self._drop(old)
        if keep:
            self.kept[i] = (tok, cache)
        return {"tokens": L_, "index": i}

    def end_to_end(self, units: list, window_s: float) -> dict:
        from chipbench.cell import percentile
        lat = [u["t1"] - u["t0"] for u in units]
        return {"ttft_p95_ms": percentile(lat, 95) * 1e3,
                "prefill_tokens_per_s": sum(u["tokens"] for u in units)
                / window_s}

    def release(self):
        self.step = None

    def control(self, indices, detail: bool = False) -> dict:
        """The control's numbers on requests `indices`: the reference in
        float8 in the program's place, held to the float32 reference as
        the program is; its tokens, at every position of each prompt, are
        the argmax of its own logits there."""
        ref.no_tf32()
        per = []
        fwd = ref_models.FORWARD[self.cfg["model_type"]]
        with torch.no_grad():
            for i in indices:
                toks = self.prompts.tokens(i)[0]
                logits, cache = fwd(self.params, self.cfg, toks, ref.FP8,
                                    every=True)
                served = logits.argmax(-1)
                del logits
                per.append(compare(self.cfg, self.params, toks, served,
                                   cache))
        return pool(per, detail)

    def sample(self, n: int) -> list[int]:
        """The requests that a run which finished n checks."""
        drawn = self.prompts.sample(n)
        self.prompts.ensure(n)
        longest = max(range(n), key=lambda i: (self.prompts.lengths[i], -i))
        return sorted(set(drawn) | {longest})

    def program(self, indices, detail: bool = False) -> dict:
        """The program's numbers on requests `indices`, each run once
        through the timed path's step, as a run checks them."""
        for i in indices:
            self.kept[i] = self._serve(i)
        return self.check([{"index": i} for i in indices], detail)

    def check(self, units: list, detail: bool = False) -> dict:
        ref.no_tf32()
        done = {u["index"] for u in units}
        per = []
        with torch.no_grad():
            for i in sorted(self.kept):
                if i not in done:
                    continue
                tok, cache = self.kept.pop(i)
                per.append(compare(self.cfg, self.params,
                                   self.prompts.tokens(i)[0], tok,
                                   _program_cache(self.cfg, cache)))
                del cache
        return pool(per, detail)
