"""The program's own spans (`repro_torch.trace`: `rt:` ranges) in a
`torch.profiler` trace of the measured window: the spans the unit's
thread opened, each idle gap of the device split over the innermost span
open during it, and each device operation put down to the innermost span
open when the host launched it.

The reduction works on plain `Event`s (`events(prof)` makes them from the
profiler's kineto events), so a CPU test can feed it a fixed list.  It
keeps to the rules of `trace.summarize`: `unit:` and `rt:` ranges copied
onto the device's row are not device work, and the gaps are the window
less the union of the device's operations.
"""
from __future__ import annotations

import bisect
import collections

Event = collections.namedtuple(
    "Event", "name on_device start end thread corr linked")


def events(prof) -> list[Event]:
    """The profiler's kineto events as `Event`s (times in ns)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [Event(e.name(), e.device_type() == cuda, e.start_ns(),
                  e.start_ns() + e.duration_ns(), e.start_thread_id(),
                  e.correlation_id(), e.linked_correlation_id())
            for e in prof.profiler.kineto_results.events()]


def _gaps(ops, t0: int, t1: int) -> list[tuple[int, int]]:
    """[t0, t1] less the union of the operations' intervals."""
    out, cur = [], t0
    for s, e in sorted(ops):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        out.append((cur, t1))
    return out


def _innermost(spans) -> list[tuple[int, int, str]]:
    """Nested spans [(start, end, name)] of one thread as consecutive
    segments, each labelled by the innermost span open over it."""
    segs, stack, t = [], [], None

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, name = stack.pop()
            if t < end:
                segs.append((t, end, name))
                t = end

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        if stack:
            close_until(s)
            if stack and t < s:
                segs.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    close_until(float("inf"))
    return segs


def attribute(evs: list[Event], t0: int, t1: int) -> dict:
    """Over the window [t0, t1] (ns):
      rt_spans        {name: [count, seconds]} of the `rt:` spans that the
                      unit's thread opened;
      idle_by_span    {label: seconds}: each idle gap split over the
                      innermost `rt:` span open on the unit's thread
                      during it, by overlap; the rest of the gap under
                      the unit's label (as `trace.summarize` labels it).
                      The parts sum to the gaps;
      device_by_span  {label: seconds}: each device operation's time under
                      the innermost `rt:` span open on the unit's thread
                      when its launch ran (a launch from autograd's thread
                      falls under the span the unit's thread is in, such
                      as `rt:train.backward`).  The launch is the CUDA API
                      call (`cu*`) of the operation's correlation id, else
                      the PyTorch call it links to; "unlinked" where
                      neither is in the trace."""
    api, calls = {}, {}
    for e in evs:
        if not e.on_device and e.corr:
            (api if e.name.startswith("cu") else calls)[e.corr] = e.start
    units, ops = [], []
    for e in evs:
        if e.end < t0 or e.start > t1:
            continue
        if e.on_device:
            if not e.name.startswith(("unit:", "rt:")):
                launch = api.get(e.corr, calls.get(e.linked))
                ops.append((max(e.start, t0), min(e.end, t1), launch))
        elif e.name.startswith("unit:"):
            units.append((e.start, e.end, e.name[5:], e.thread))
    threads = {u[3] for u in units}
    spans = [(e.start, e.end, e.name) for e in evs
             if not e.on_device and e.name.startswith("rt:")
             and e.thread in threads and e.end >= t0 and e.start <= t1]
    segs = _innermost(spans)
    seg_starts = [s[0] for s in segs]
    units.sort()
    unit_starts = [u[0] for u in units]

    def unit_label(t):
        i = bisect.bisect_right(unit_starts, t) - 1
        if i >= 0 and units[i][0] <= t < units[i][1]:
            return units[i][2]
        return "between units"

    def span_at(t):
        i = bisect.bisect_right(seg_starts, t) - 1
        if i >= 0 and segs[i][0] <= t < segs[i][1]:
            return segs[i][2]
        return unit_label(t)

    rt_spans: dict = {}
    for s, e, name in spans:
        n = rt_spans.setdefault(name, [0, 0.0])
        n[0] += 1
        n[1] += (min(e, t1) - max(s, t0)) / 1e9
    idle = collections.Counter()
    j = 0
    for gs, ge in _gaps([o[:2] for o in ops], t0, t1):
        covered = 0
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < ge:
            part = min(ge, segs[k][1]) - max(gs, segs[k][0])
            if part > 0:
                idle[segs[k][2]] += part / 1e9
                covered += part
            k += 1
        if ge - gs > covered:
            idle[unit_label(gs)] += (ge - gs - covered) / 1e9
    device = collections.Counter()
    for s, e, launch in ops:
        device["unlinked" if launch is None else span_at(launch)] += \
            (e - s) / 1e9
    return {"rt_spans": rt_spans, "idle_by_span": dict(idle),
            "device_by_span": dict(device)}
