"""Prefill requests of a model type that `kinds/prefill` does not map, as
`kinds/prefill` serves and checks them: one client in a closed loop,
batch 1, the step of `build_prefill_step` over each prompt, the same
sample checked against the plain reference with the same numbers.

The model type is the configuration's `model_type`: `archs/<model_type>.py`
gives the port's ModelConfig and RunConfig, the cache as the reference
keeps it and the metrics' counts, and names the reference module under
`ref/`, whose `forward` is entered in `ref.models.FORWARD` for
`prefill.compare`.  Each unit also records the launches of the SSD
kernel and of K3 it made (`ssd_launches`, `flash_launches`: the kernel
modules' own counts, which count with the tracer off).

Besides `prefill.compare`'s numbers, a Mamba2 block's SSM state is held
head by head and its conv window position by position (`pool`): the
largest error over the blocks, `state_err` and `conv_err`, reads the
deepest blocks, where the error carried down the 40 layers is largest,
and one wrong head of 128 moves it by about a tenth.

The readings that the cell's limits are set from (the lower: the
program's largest over seeds; the upper: the control's least):

    PYTHONPATH=src python3 -m chipbench.kinds.prefill_arch \\
        --workload <name> --seeds a,b,... [--control-seeds c,d,...] \\
        [--rounds r]

prints one JSON line a seed, as `chipbench.calibrate` does for a
`prefill` cell.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from chipbench import gen, ref, weights
from chipbench.kinds import prefill
from chipbench.ref import models as ref_models


_WANT: dict = {}        # the float32 reference's cache of the last compare


def _forward(reference):
    """`reference.forward`, keeping the cache of its float32 calls in
    `_WANT` for the numbers that `prefill.compare` does not take."""
    def forward(params, cfg, tokens, prec, every=False):
        logits, cache = reference.forward(params, cfg, tokens, prec,
                                          every=every)
        if prec is ref.F32:
            _WANT["cache"] = cache
        return logits, cache
    return forward


def pool(per_request, detail: bool = False) -> dict:
    """`prefill.pool`'s numbers, and the Mamba2 blocks' medians over the
    sample, each error relative as `ref.token_err` takes it:
      state_med       the median error of a head's SSM state over every
                      block and head: a fault of the SSD in every head;
      state_head_med  the largest over the heads of a head's median over
                      every block: a fault in a few heads;
      conv_med        the median error of a conv window's position over
                      every block."""
    out = prefill.pool(per_request, detail)
    states = torch.stack([g["state_errs"] for g in per_request])
    out["state_med"] = float(states.median())
    out["state_head_med"] = float(states.flatten(0, 1).median(0).values.max())
    out["conv_med"] = float(torch.stack(
        [g["conv_errs"] for g in per_request]).median())
    if detail:          # (requests, blocks, heads) -> each block's median
        out["detail"]["state_block_med"] = states.transpose(0, 1).flatten(
            1).median(1).values.tolist()
    return out


class Job(prefill.Job):

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        kind = self.cfg["model_type"]
        self.arch = importlib.import_module(f"chipbench.archs.{kind}")
        self.reference = importlib.import_module(
            f"chipbench.ref.{self.arch.REF}")
        ref_models.FORWARD[kind] = _forward(self.reference)

    def setup(self, warm: bool = True):
        from repro_torch.kernels import flash_attention, ssd
        from repro_torch.models import layers as L
        from repro_torch.models import registry
        from repro_torch.train import steps
        self.kernels = (ssd, flash_attention)
        cfg = self.cfg
        # a program without the family fails here, before any weight
        self.mc = self.arch.model_config(cfg)
        self.rc = self.arch.prefill_run(cfg)
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
        self.drawn = []

    def unit(self, i: int) -> dict:
        ssd, fa = self.kernels
        s0, f0 = ssd.LAUNCHES, fa.LAUNCHES
        u = super().unit(i)
        u["ssd_launches"] = ssd.LAUNCHES - s0
        u["flash_launches"] = fa.LAUNCHES - f0
        return u

    def check(self, units: list, detail: bool = False) -> dict:
        ref.no_tf32()
        if self.device.type == "cuda":   # the window's blocks, for the
            torch.cuda.empty_cache()     # reference's large terms
        done = {u["index"] for u in units}
        per = []
        with torch.no_grad():
            for i in sorted(self.kept):
                if i not in done:
                    continue
                tok, cache = self.kept.pop(i)
                per.append(self._compare(
                    self.prompts.tokens(i)[0], tok,
                    self.arch.program_cache(self.cfg, cache)))
                del cache
        return pool(per, detail)

    def control(self, indices, detail: bool = False) -> dict:
        """`prefill.Job.control`, with this module's numbers."""
        ref.no_tf32()
        per = []
        with torch.no_grad():
            for i in indices:
                toks = self.prompts.tokens(i)[0]
                logits, cache = self.reference.forward(
                    self.params, self.cfg, toks, ref.FP8, every=True)
                served = logits.argmax(-1)
                del logits
                per.append(self._compare(toks, served, cache))
        return pool(per, detail)

    def _compare(self, tokens, served, got: dict) -> dict:
        """`prefill.compare`'s numbers of one request, with the errors of
        each Mamba2 block's SSM state by head (`state_errs`, blocks x
        heads) and of its conv window by position (`conv_errs`)."""
        out = prefill.compare(self.cfg, self.params, tokens, served, got)
        want = _WANT.pop("cache")
        for key in ("state", "conv"):
            out[f"{key}_errs"] = torch.stack([
                ref.token_err(g, w) for g, w in zip(got[key], want[key])
            ]).cpu()
        return out


def readings(cell, seed: int, control: bool, device, rounds: int = 12):
    """The program's numbers on the requests that a run which finished
    `rounds` rounds checks, with the readings they are taken from under
    `detail`; with `control`, the control's on the same requests."""
    job = Job(cell, seed, device)
    job.setup(warm=False)
    idx = job.sample(rounds * job.prompts.per_round)
    out = {"program": job.program(idx, detail=True)}
    if control:
        out["control"] = job.control(idx, detail=True)
    out["detail"] = {k: v.pop("detail") for k, v in list(out.items())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=lambda s: [int(x) for x in s.split(",")
                                               if x], required=True)
    ap.add_argument("--control-seeds", type=lambda s: [
        int(x) for x in s.split(",") if x], default=[])
    ap.add_argument("--rounds", type=int, default=12)
    args = ap.parse_args(argv)
    from chipbench.calibrate import _free
    from chipbench.cell import load_cell
    if not torch.cuda.is_available():
        print("prefill_arch: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        out = readings(cell, seed, seed in args.control_seeds, "cuda",
                       args.rounds)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t, **out}),
              flush=True)
        _free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
