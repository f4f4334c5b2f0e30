"""The reduction of the program's spans (`spans.attribute`) on a fixed,
kineto-like event list, beside `trace.summarize` on the same list.

The window is [0, 100] (ns).  One unit, `prefill`, on thread 1 opens
`rt:moe` [10, 60] with its child `rt:moe.route` [20, 30], then `rt:attn`
[70, 90].  The device runs [0, 15], [40, 50], [65, 75] and [99, 100], so
its gaps are [15, 40], [50, 65] and [75, 99]."""
import collections

import pytest
import torch

from chipbench import spans
from chipbench import trace as trace_mod

E = spans.Event
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

EVENTS = [
    E("unit:prefill", False, 0, 100, 1, 1, 0),
    E("rt:moe", False, 10, 60, 1, 2, 0),
    E("rt:moe.route", False, 20, 30, 1, 3, 0),
    E("aten::mm", False, 22, 24, 1, 4, 0),
    E("aten::add", False, 45, 46, 2, 5, 0),      # autograd's thread
    E("rt:attn", False, 40, 50, 2, 6, 0),        # not the unit's thread
    E("rt:attn", False, 70, 90, 1, 7, 0),
    E("aten::cat", False, 95, 96, 2, 8, 0),
    E("aten::copy_", False, -5, -4, 1, 9, 0),    # before the window
    E("cudaLaunchKernel", False, 72, 73, 1, 104, 0),
    E("kernel_a", True, 0, 15, 0, 101, 9),
    E("kernel_b", True, 40, 50, 0, 102, 4),
    E("kernel_c", True, 65, 75, 0, 103, 5),
    E("kernel_d", True, 99, 100, 0, 104, 0),     # launched by the API call
    E("rt:moe", True, 0, 75, 0, 0, 0),           # the span's device copy
    E("unit:prefill", True, 0, 75, 0, 0, 0),
]


def test_idle_by_span_splits_each_gap_by_the_innermost_span():
    got = spans.attribute(EVENTS, 0, 100)["idle_by_span"]
    want = {"rt:moe": 25, "rt:moe.route": 10, "rt:attn": 15, "prefill": 14}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v / 1e9), k
    assert sum(got.values()) == pytest.approx((25 + 15 + 24) / 1e9)


def test_device_by_span_follows_the_launch():
    got = spans.attribute(EVENTS + [E("kernel_e", True, 80, 82, 0, 0, 77)],
                          0, 100)["device_by_span"]
    # a launched before the unit; b in rt:moe.route; c from autograd's
    # thread while the unit was in rt:moe; d by a CUDA call of no PyTorch
    # call, in rt:attn; e from no recorded launch
    want = {"between units": 15, "rt:moe.route": 10, "rt:moe": 10,
            "rt:attn": 1, "unlinked": 2}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v / 1e9), k


def test_rt_spans_of_the_units_thread():
    got = spans.attribute(EVENTS, 0, 100)["rt_spans"]
    assert got == {"rt:moe": [1, pytest.approx(50e-9)],
                   "rt:moe.route": [1, pytest.approx(10e-9)],
                   "rt:attn": [1, pytest.approx(20e-9)]}


@pytest.mark.parametrize("spans_", [
    [(0, 10, "a")],
    [(0, 10, "a"), (2, 4, "b"), (4, 8, "c"), (5, 6, "d")],
    [(0, 10, "a"), (0, 4, "b"), (10, 12, "c")],
    [(0, 3, "a"), (5, 9, "b"), (6, 9, "c")],
])
def test_innermost_segments_tile_the_spans(spans_):
    segs = spans._innermost(spans_)
    for s, e, name in segs:
        assert s < e
        inner = min((x for x in spans_ if x[0] <= s and e <= x[1]),
                    key=lambda x: (x[1] - x[0], -x[0]))
        assert name == inner[2]
    covered = set()
    for s, e, _ in spans_:
        covered |= set(range(s, e))
    got = set()
    for s, e, _ in segs:
        assert not got & set(range(s, e))
        got |= set(range(s, e))
    assert got == covered


class _Kineto:
    def __init__(self, e):
        self.e = e

    def name(self):
        return self.e.name

    def start_ns(self):
        return self.e.start

    def duration_ns(self):
        return self.e.end - self.e.start

    def device_type(self):
        return CUDA if self.e.on_device else CPU

    def start_thread_id(self):
        return self.e.thread

    def correlation_id(self):
        return self.e.corr

    def linked_correlation_id(self):
        return self.e.linked


class _Prof:
    """What `summarize` and `spans.events` read of a profiler."""

    def __init__(self, evs):
        kin = [_Kineto(e) for e in evs]
        results = type("R", (), {"events": lambda self: kin})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_summarize_agrees_and_keeps_its_keys():
    """Without the program's ranges on the device's row, `summarize`'s
    values are those of its rules, and the span reduction's gaps sum to
    its idle time."""
    evs = [e for e in EVENTS if not (e.on_device and e.name == "rt:moe")]
    prof = _Prof(evs)
    assert spans.events(prof) == evs
    s = trace_mod.summarize(prof, 0, 100)
    assert s["busy_s"] == pytest.approx(36e-9)
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["device"] == [(0, 15, "kernel_a"), (40, 50, "kernel_b"),
                           (65, 75, "kernel_c"), (99, 100, "kernel_d")]
    assert s["idle"] == collections.Counter(
        {"prefill": pytest.approx(64e-9)})
    idle = spans.attribute(evs, 0, 100)["idle_by_span"]
    assert sum(idle.values()) == pytest.approx(
        s["window_s"] - s["busy_s"])
