#!/usr/bin/env python3
"""Where the time of the port's qwen3-4b prefill, serving and train step
goes, on a card.

    python3 profile_model.py [--phases prefill,serve,train]
                             [--train-layers 2[,18,...]]

Builds the model, the prompts and the requests of `chip_smoke.py` (its
helpers: qwen3-4b at full width and depth, random f32 parameters from a
seed, bf16 compute), warms each path up once, then traces it with
torch.profiler:

  prefill - one build_prefill_step call, attn_impl="flash", B=2 x 4096;
  serve   - one BatchedServer wave of chip_smoke's 4 requests (prompts of
            8-64 tokens, 16 new tokens each: 79 lockstep decode steps);
  train   - one build_train_step call at chip_smoke's phase-12 shape
            (qwen3-4b at full width, 2 layers; 4 x 4096 tokens in 4
            microbatches, remat, chunked attention, AdamW in place), once
            for each depth of --train-layers: the share of each kernel
            group depends on the depth, as the vocabulary-wide
            cross-entropy, embedding and lm_head do not grow with it.

For each it prints one JSON line: the wall time with and without the
profiler, the device's busy time (the union of its kernels' and copies'
intervals) and busy share of the wall time, the kernel launches and
top-level PyTorch calls issued, and device time by kernel group and of
the 12 kernels that take the most.  Exits non-zero without a card.
"""
from __future__ import annotations

import collections
import json
import sys
import time

import chip_smoke

# kernel name fragments -> group, first match wins
GROUPS = (("flash_attention", ("flash_fwd",)),
          ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
          ("copy_cast", ("copy", "Memcpy", "Memset")),
          ("softmax", ("softmax",)),
          ("index", ("index", "gather", "scatter")),
          ("reduce", ("reduce",)),
          ("elementwise", ("elementwise",)))
_LAUNCH = {"cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
           "cuLaunchKernelEx"}


def _group(name: str) -> str:
    for group, parts in GROUPS:
        if any(p in name for p in parts):
            return group
    return "other"


def _union_s(intervals) -> float:
    total, cur = 0.0, None
    for start, end in sorted(intervals):
        if cur is None or start > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e6                                   # us -> s


def summarize(torch, prof, wall_s: float, plain_wall_s: float) -> dict:
    """Busy time, launches, calls and device time by group from a trace."""
    device, launches, calls = [], 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(e)
        elif e.name in _LAUNCH:
            launches += 1
        elif e.cpu_parent is None and e.name.startswith("aten::"):
            calls += 1
    busy = _union_s((e.time_range.start, e.time_range.end) for e in device)
    by_group, by_kernel = collections.Counter(), collections.Counter()
    for e in device:
        s = (e.time_range.end - e.time_range.start) / 1e6
        by_group[_group(e.name)] += s
        by_kernel[e.name[:120]] += s
    return {"wall_s": wall_s, "wall_s_unprofiled": plain_wall_s,
            "device_busy_s": busy, "device_busy_share": busy / wall_s,
            "kernel_launches": launches, "top_level_calls": calls,
            "device_s_by_group": dict(by_group.most_common()),
            "device_s_top_kernels": dict(by_kernel.most_common(12))}


def trace(torch, fn) -> dict:
    """fn() once warm, once timed plain, once under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    def timed():
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    fn()
    plain = timed()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed()
    return summarize(torch, prof, wall, plain)


def trace_train(torch, dev, n_layers: int) -> dict:
    """One train step at phase 12's shape and `n_layers` deep, on random
    tokens from the seed (each of trace's three calls updates the state
    in place)."""
    from repro_torch.models import layers, registry
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_train_step

    tcfg = chip_smoke.train_config()
    model, rc = tcfg.model.scaled(n_layers=n_layers), tcfg.rc
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    params = layers.tree_init(registry.param_defs(model), gen)
    state = adamw.init_state(params)
    nmb = rc.num_microbatches
    toks = torch.randint(0, model.vocab, (nmb, rc.global_batch // nmb,
                                          rc.seq_len), generator=gen,
                         device=dev, dtype=torch.int32)
    labels = toks.roll(-1, dims=-1)
    labels[..., -1] = 0
    step = build_train_step(model, rc, device=dev)
    torch.cuda.reset_peak_memory_stats()
    out = trace(torch, lambda: step(params, state, {"tokens": toks,
                                                    "labels": labels}))
    tokens = rc.global_batch * rc.seq_len
    return {**out, "layers": n_layers, "tokens": tokens,
            "params": sum(t.numel() for _, t in layers.tree_items(params)),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "tokens_per_s_unprofiled": tokens / out["wall_s_unprofiled"]}


def trace_model(torch, dev, phases) -> dict:
    """The prefill and serve phases named in `phases`, on chip_smoke's
    full-depth model (freed on return)."""
    from repro_torch.models.config import RunConfig
    from repro_torch.train.serve import BatchedServer
    from repro_torch.train.steps import build_prefill_step

    cfg, params = chip_smoke.model_params(torch, dev)
    out = {}
    if "prefill" in phases:
        tokens = chip_smoke.prefill_tokens(torch, cfg, dev)
        step = build_prefill_step(cfg, RunConfig(
            seq_len=chip_smoke.PREFILL_S, global_batch=chip_smoke.PREFILL_B,
            kind="prefill", attn_impl="flash"), device=dev)
        out["prefill"] = trace(torch, lambda: step(params,
                                                   {"tokens": tokens}))
    if "serve" in phases:
        srv = BatchedServer(cfg, params, max_seq=256, device=dev)
        reqs = chip_smoke.serve_requests(cfg)  # generate() fills them in
        serve = trace(torch, lambda: srv.generate(
            chip_smoke.serve_requests(cfg)))
        steps = max(len(r.prompt) for r in reqs) + reqs[0].max_new - 1
        out["serve"] = serve | {
            "decode_steps": steps,
            "wall_ms_per_step": serve["wall_s"] / steps * 1e3,
            "wall_ms_per_step_unprofiled":
                serve["wall_s_unprofiled"] / steps * 1e3}
    return out


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="prefill,serve,train")
    ap.add_argument("--train-layers", default=str(chip_smoke.TRAIN_LAYERS))
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("profile_model: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

    def emit(phase, rec):
        print(json.dumps({"phase": phase, "model": chip_smoke.MODEL,
                          "card": torch.cuda.get_device_name(0),
                          "nvidia_smi": chip_smoke.nvidia_smi(), **rec}),
              flush=True)

    if "prefill" in phases or "serve" in phases:
        for phase, rec in trace_model(torch, dev, phases).items():
            emit(phase, rec)
        torch.cuda.empty_cache()
    if "train" in phases:            # each depth printed as it is done
        for n in map(int, args.train_layers.split(",")):
            emit("train", trace_train(torch, dev, n))
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
