"""Reduction of a `torch.profiler` trace of the measured window to what
the per-layer readers and the result's `breakdown` use: the device's busy
time (the union of its operations' intervals), device time by operation,
and the idle gaps labelled by what the host was doing.

Device operations are grouped as `profile_model.py` groups them (name
fragments, first match wins); a gap is labelled by the benchmark's span
(`record_function("unit:<kind>")`) and the outermost PyTorch call that
were open when the gap began.
"""
from __future__ import annotations

import bisect
import collections

import torch
from torch.profiler import ProfilerActivity, profile

GROUPS = (("flash_attention", ("flash_fwd",)),
          ("xor_parity", ("xor_rows",)),
          ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
          ("copy_cast", ("copy", "Memcpy", "Memset")),
          ("softmax", ("softmax",)),
          ("index", ("index", "gather", "scatter")),
          ("reduce", ("reduce",)),
          ("elementwise", ("elementwise",)))


def group(name: str) -> str:
    for g, parts in GROUPS:
        if any(p in name for p in parts):
            return g
    return "other"


def start(device) -> profile | None:
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _outermost(spans):
    """The spans [(start, end, name)] that no other span contains."""
    out, end = [], -1
    for s in sorted(spans):
        if s[0] >= end:
            out.append(s)
            end = s[1]
        elif s[1] > end:
            end = s[1]
    return out


def _covering(spans, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][0] <= t < spans[i][1]:
        return spans[i][2]
    return None


def summarize(prof, t0_ns: int, t1_ns: int) -> dict:
    """busy_s, window_s, device time by operation name, the device
    operations [(name, start_ns, end_ns)], and idle seconds by label,
    over [t0_ns, t1_ns]."""
    device, units, calls = [], [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if s + d < t0_ns or s > t1_ns:
            continue
        name = e.name()
        if name.startswith("unit:") and \
                e.device_type() == torch.autograd.DeviceType.CUDA:
            continue                  # the span's copy on the device's row
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((max(s, t0_ns), min(s + d, t1_ns), name))
        elif name.startswith("unit:"):
            units.append((s, s + d, name[5:]))
        elif name.startswith("aten::"):
            calls.append((s, s + d, name))
    device.sort()
    busy, gaps = 0, []
    cur_s, cur_e = None, t0_ns
    for s, e, _ in device:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if cur_e < t1_ns:
        gaps.append((cur_e, t1_ns))
    units, calls = _outermost(units), _outermost(calls)
    u_starts, c_starts = [u[0] for u in units], [c[0] for c in calls]
    idle = collections.Counter()
    for gs, ge in gaps:
        label = _covering(units, u_starts, gs) or "between units"
        call = _covering(calls, c_starts, gs)
        idle[f"{label}/{call}" if call else label] += (ge - gs) / 1e9
    by_op = collections.Counter()
    for s, e, name in device:
        by_op[name] += (e - s) / 1e9
    return {"busy_s": busy / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
            "device": device, "by_op": by_op, "idle": idle}


def breakdown(summary: dict) -> dict:
    """The result line's `breakdown`: the ten device operations that took
    most time and the ten idle labels that took most, in seconds."""
    ops = [[f"{group(n)}:{n[:100]}", s]
           for n, s in summary["by_op"].most_common(10)]
    return {"device_ops": ops,
            "idle_gaps": [[n, s] for n, s in summary["idle"].most_common(10)]}
