"""Training steps fed from the simulated store: the loop body of
`Trainer.run` without its saves, `Trainer._batch(step)` (the
TokenPipeline's reads of the striped corpus) then `Trainer.step_fn`
(forward and backward of each microbatch, AdamW in place).  A unit is a
step; its tokens are the batch's.

Set-up builds the Trainer (its TokenDataset writes the corpus to the
store from the seed, through the client that reads it), gives it
parameters made from the seed and a fresh AdamW state, and drives it through `checked_steps` steps with the
window's own call; the window then continues the same Trainer.

Once the window has closed, the same Trainer takes one more step through
the window's call and feed (the late step), from a copy on the host of
the parameters and first moments that the window left.

Checked after that, against the plain reference (`ref/train.py`,
float32) run from the same parameters on the same corpus for the first
steps, and from the host copy for the late step (the one reading that
follows the program's own state), each number the worst of its kind:
  loss_gap   |loss - reference| / |reference| over the first steps;
  gnorm_gap  the same for the gradient norm the step reports;
  grad_gap   over the leaves, the gap between the norms of the first
             gradient as AdamW took it (its first moment after one step,
             over 1 - b1) and the reference's, over the larger of the
             reference leaf's norm and the median leaf's;
  change_gap the same for the norm of each leaf's change over the first
             steps, leaves whose reference gradient is under a thousandth
             of the median leaf's left out (they move by round-off);
  late_loss_gap, late_gnorm_gap, late_grad_gap  loss_gap, gnorm_gap and
             grad_gap of the late step (its gradient from its first
             moment and the copy's: m' - b1 m over 1 - b1);
  batch_diff batches of the window and the late step whose tokens or
             labels differ from the corpus rows the data order names.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from chipbench import ref, weights
from chipbench import models as bench_models
from chipbench.ref import train as ref_train


def _norms(pairs) -> dict:
    return {name: float(t.double().norm()) for name, t in pairs}


def _gap(got: dict, want: dict, keep=None) -> float:
    med = statistics.median(want.values())
    return max(abs(got[k] - want[k]) / max(want[k], med)
               for k in want if keep is None or k in keep)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Job:
    unit_name = "train"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.t = cell.config, cell.traffic
        self.batches: list = []

    def _leaves(self):
        from repro_torch.models import layers as L
        from repro_torch.models import registry
        return [(p, tuple(d.shape), d.init)
                for p, d in L.tree_items(registry.param_defs(self.mc))]

    def _p0(self):
        return weights.stream(self._leaves(), self.cfg.get("init", []),
                              torch.float32, self.seed, self.device)

    def setup(self):
        from repro_torch.core.cluster import LustreCluster
        from repro_torch.models.config import RunConfig
        from repro_torch.optim import adamw
        from repro_torch.train.trainer import Trainer, TrainerConfig
        cfg, t = self.cfg, self.t
        self.mc = bench_models.model_config(cfg)
        run = cfg["run"]
        self.rc = RunConfig(
            seq_len=t["seq_len"], global_batch=t["batch"], kind="train",
            num_microbatches=t["microbatches"], remat=run["remat"],
            param_dtype=run["param_dtype"], compute_dtype=run["compute_dtype"],
            attn_impl=run["attn_impl"])
        opt = adamw.AdamWConfig()
        if any(getattr(opt, k) != v for k, v in cfg["optimizer"].items()):
            raise ValueError(f"the Trainer's AdamW {opt} is not the "
                             f"configuration's {cfg['optimizer']}")
        cluster = LustreCluster(
            osts=t["osts"], ost_failover=t["ost_failover"],
            clients=t["clients"], max_cached_mb=t["max_cached_mb"],
            device=self.device)
        self.tr = Trainer(cluster, TrainerConfig(
            model=self.mc, rc=self.rc, dataset_seqs=t["dataset_seqs"],
            seed=self.seed))
        self.corpus = torch.from_numpy(ref_train.corpus(
            self.seed, t["dataset_seqs"], t["seq_len"],
            cfg["vocab_size"])).to(self.device)
        self.tr.params = weights.make(self._leaves(), cfg.get("init", []),
                                      torch.float32, self.seed, self.device)
        self.tr.opt_state = adamw.init_state(self.tr.params)
        from repro_torch.models.layers import tree_items
        self.first = []
        for i in range(t["checked_steps"]):
            self.first.append(self.unit(i))
            if i == 0:
                self.g1 = {".".join(p): float(m.double().norm()) / (1 - opt.b1)
                           for p, m in tree_items(self.tr.opt_state["m"])}
        params = dict((".".join(p), v) for p, v in tree_items(self.tr.params))
        self.change = _norms((".".join(p), params[".".join(p)] - p0)
                             for p, p0 in self._p0())
        self.batches.clear()

    def unit(self, i: int) -> dict:
        tr = self.tr
        step = tr.step
        t0 = time.perf_counter()
        batch = tr._batch(step)
        data_s = time.perf_counter() - t0
        tr.params, tr.opt_state, m = tr.step_fn(tr.params, tr.opt_state,
                                                batch)
        tr.step += 1
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        self.batches.append((step, batch["tokens"], batch["labels"]))
        return {"tokens": batch["tokens"].numel(), "step": step,
                "data_s": data_s, "loss": loss, "grad_norm": gnorm}

    def end_to_end(self, units: list, window_s: float) -> dict:
        return {"train_tokens_per_s": sum(u["tokens"] for u in units)
                / window_s}

    def release(self):
        """The late step, then the program's state freed."""
        from repro_torch.models.layers import tree_items, tree_map
        tr = self.tr
        self.p_late = tree_map(lambda t: t.to("cpu", copy=True), tr.params)
        m0 = {".".join(p): m.to("cpu", copy=True)
              for p, m in tree_items(tr.opt_state["m"])}
        self.late = self.unit(tr.step)
        b1 = self.cfg["optimizer"]["b1"]
        self.late["g"] = {
            k: float((m - b1 * m0[k].to(m.device)).double().norm())
            / (1 - b1) for k, m in ((".".join(p), m) for p, m in
                                    tree_items(tr.opt_state["m"]))}
        del m0
        tr.params = tr.opt_state = None
        _free(self.device)

    def reference(self, prec) -> dict:
        """The reference's readings over the first steps in `prec`."""
        ref.no_tf32()
        W = weights.make(self._leaves(), self.cfg.get("init", []),
                         torch.float32, self.seed, self.device)
        state = {"t": 0, "m": {}, "v": {}}
        out = {"loss": [], "grad_norm": []}
        for s in range(self.t["checked_steps"]):
            toks, labels = ref_train.batch(self.corpus, s, self.t, self.seed)
            toks = toks.reshape(-1, toks.shape[-1])
            lo, g = ref_train.grads(W, self.cfg, toks, labels.reshape(
                toks.shape), self.t["microbatches"], prec)
            gn = ref_train.adamw(W, g, state, self.cfg["optimizer"])
            if s == 0:
                scale = min(1.0, self.cfg["optimizer"]["grad_clip"]
                            / (gn + 1e-12))
                out["g1"] = {k: float(v.double().norm()) * scale
                             for k, v in g.items()}
            del g
            out["loss"].append(lo)
            out["grad_norm"].append(gn)
        flat = dict(ref.flat(W))
        out["change"] = _norms((".".join(p), flat[".".join(p)] - p0)
                               for p, p0 in self._p0())
        return out

    def late_reference(self, prec) -> dict:
        """The reference's readings of the late step in `prec`, from the
        host copy of the parameters the window left."""
        ref.no_tf32()
        W = {}
        for name, t in ref.flat(self.p_late):
            node = W
            *head, last = name.split(".")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = t.to(self.device)
        toks, labels = ref_train.batch(self.corpus, self.late["step"],
                                       self.t, self.seed)
        toks = toks.reshape(-1, toks.shape[-1])
        lo, g = ref_train.grads(W, self.cfg, toks, labels.reshape(
            toks.shape), self.t["microbatches"], prec)
        gn = float(torch.sqrt(sum((x.double() ** 2).sum()
                                  for x in g.values())))
        scale = min(1.0, self.cfg["optimizer"]["grad_clip"] / (gn + 1e-12))
        return {"loss": lo, "grad_norm": gn,
                "g": {k: float(v.double().norm()) * scale
                      for k, v in g.items()}}

    def late_numbers(self, got: dict, want: dict) -> dict:
        return {"late_loss_gap": abs(got["loss"] - want["loss"])
                / abs(want["loss"]),
                "late_gnorm_gap": abs(got["grad_norm"] - want["grad_norm"])
                / abs(want["grad_norm"]),
                "late_grad_gap": _gap(got["g"], want["g"])}

    def numbers(self, got: dict, want: dict) -> dict:
        med = statistics.median(want["g1"].values())
        moved = {k for k, v in want["g1"].items() if v >= 1e-3 * med}
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["loss"], want["loss"])),
            "gnorm_gap": max(abs(a - b) / abs(b) for a, b in
                             zip(got["grad_norm"], want["grad_norm"])),
            "grad_gap": _gap(got["g1"], want["g1"]),
            "change_gap": _gap(got["change"], want["change"], moved)}

    def program(self) -> dict:
        return {"loss": [u["loss"] for u in self.first],
                "grad_norm": [u["grad_norm"] for u in self.first],
                "g1": self.g1, "change": self.change}

    def check(self, units: list) -> dict:
        diff = 0
        for step, toks, labels in self.batches:
            want_t, want_l = ref_train.batch(self.corpus, step, self.t,
                                             self.seed)
            diff += not (torch.equal(toks.reshape(want_t.shape), want_t) and
                         torch.equal(labels.reshape(want_l.shape), want_l))
        self.batches.clear()
        out = self.numbers(self.program(), self.reference(ref.F32))
        _free(self.device)
        out.update(self.late_numbers(self.late,
                                     self.late_reference(ref.F32)))
        out["batch_diff"] = float(diff)
        return out


class HalfBatch(Job):
    """A fault: each step trains on the first half of its microbatches
    only, the mean taken over them."""

    def unit(self, i: int) -> dict:
        if i == 0:
            import dataclasses
            from repro_torch.train import steps
            n = self.rc.num_microbatches // 2
            half = steps.build_train_step(self.mc, dataclasses.replace(
                self.rc, num_microbatches=n,
                global_batch=self.rc.global_batch // 2), device=self.device)
            self.tr.step_fn = lambda p, o, b: half(p, o, {
                k: v[:n] if n > 1 else v[0] for k, v in b.items()})
        return super().unit(i)
