#!/usr/bin/env python3
"""Where the time of the port's qwen3-4b prefill and serving goes, on a card.

    python3 profile_model.py

Builds the model, the prompts and the requests of `chip_smoke.py` (its
helpers: qwen3-4b at full width and depth, random f32 parameters from a
seed, bf16 compute), warms each path up once, then traces it with
torch.profiler:

  prefill - one build_prefill_step call, attn_impl="flash", B=2 x 4096;
  serve   - one BatchedServer wave of chip_smoke's 4 requests (prompts of
            8-64 tokens, 16 new tokens each: 79 lockstep decode steps).

For each it prints one JSON line: the wall time with and without the
profiler, the device's busy time (the union of its kernels' and copies'
intervals) and busy share of the wall time, the kernel launches and
top-level PyTorch calls issued, and device time by kernel group.  Exits
non-zero without a card.
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
    by_group = collections.Counter()
    for e in device:
        by_group[_group(e.name)] += (e.time_range.end
                                     - e.time_range.start) / 1e6
    return {"wall_s": wall_s, "wall_s_unprofiled": plain_wall_s,
            "device_busy_s": busy, "device_busy_share": busy / wall_s,
            "kernel_launches": launches, "top_level_calls": calls,
            "device_s_by_group": dict(by_group.most_common())}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_model: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.models.config import RunConfig
    from repro_torch.train.serve import BatchedServer
    from repro_torch.train.steps import build_prefill_step

    dev = torch.device("cuda")
    cfg, params = chip_smoke.model_params(torch, dev)
    tokens = chip_smoke.prefill_tokens(torch, cfg, dev)
    step = build_prefill_step(cfg, RunConfig(
        seq_len=chip_smoke.PREFILL_S, global_batch=chip_smoke.PREFILL_B,
        kind="prefill", attn_impl="flash"), device=dev)
    out = {"prefill": trace(torch, lambda: step(params, {"tokens": tokens}))}
    srv = BatchedServer(cfg, params, max_seq=256, device=dev)
    reqs = chip_smoke.serve_requests(cfg)      # generate() fills them in
    serve = trace(torch, lambda: srv.generate(
        chip_smoke.serve_requests(cfg)))
    steps = max(len(r.prompt) for r in reqs) + reqs[0].max_new - 1
    serve |= {"decode_steps": steps,
              "wall_ms_per_step": serve["wall_s"] / steps * 1e3,
              "wall_ms_per_step_unprofiled":
                  serve["wall_s_unprofiled"] / steps * 1e3}
    out["serve"] = serve
    for phase, rec in out.items():
        print(json.dumps({"phase": phase, "model": cfg.name,
                          "card": torch.cuda.get_device_name(0),
                          "nvidia_smi": chip_smoke.nvidia_smi(), **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
