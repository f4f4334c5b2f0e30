"""RPC tracing + latency metrics (ORNL MELT-style monitoring plane).

Every traced RPC produces exactly one *span* on the target that executed
it: (op, export uuid, jobid, queue wait, service time, seeks, bytes).
Spans land in per-target :class:`TargetMetrics` — log2-bucketed latency
histograms keyed three ways (by op, by export, by jobid) so the
aggregation tree (`repro_torch.tools.monitor`) can answer "p99 for jobid X
across the cluster" by *merging buckets*, never by shipping raw samples.

Exactly-once: the trace id is assigned when the client constructs the
Request and never changes across resends, replays, or reply-cache-served
retries (ptlrpc reuses the same Request object through recovery).  The
registry dedups on trace id, so a span is recorded the first time a
target *finishes executing* the request and every later arrival of the
same id is suppressed (`dup_suppressed` counts them).  The registry
lives on the Simulator — it survives target crash/restart, which is what
makes replay-after-crash count once, not twice.

All times are **virtual-clock** seconds; histogram buckets are log2-
spaced microseconds (bucket i covers (2^(i-1), 2^i] µs), which keeps a
histogram ~50 ints wide no matter how many samples it absorbs.
"""
from __future__ import annotations

import math


class LatencyHistogram:
    """Log2-bucketed latency histogram (microsecond buckets).

    Mergeable: cluster-wide quantiles come from summing per-target
    bucket arrays. Quantiles are reported as the bucket's upper bound —
    deterministic and safe (never understates a latency).
    """

    __slots__ = ("buckets", "count", "total_s", "max_s")

    MAX_BUCKET = 63                     # 2^63 us ~ 292k years: plenty

    def __init__(self):
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    @staticmethod
    def bucket_of(seconds: float) -> int:
        us = seconds * 1e6
        if us <= 1.0:
            return 0
        return min(LatencyHistogram.MAX_BUCKET,
                   max(0, math.ceil(math.log2(us))))

    def record(self, seconds: float):
        b = self.bucket_of(seconds)
        self.buckets[b] = self.buckets.get(b, 0) + 1
        self.count += 1
        self.total_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def merge(self, other: "LatencyHistogram | dict"):
        """Absorb another histogram (object or its to_dict() form)."""
        if isinstance(other, LatencyHistogram):
            buckets, cnt = other.buckets, other.count
            tot, mx = other.total_s, other.max_s
        else:
            buckets = {int(k): v for k, v in other.get("buckets", {}).items()}
            cnt = other.get("count", sum(buckets.values()))
            tot = other.get("total_s", 0.0)
            mx = other.get("max_s", 0.0)
        for b, n in buckets.items():
            self.buckets[b] = self.buckets.get(b, 0) + n
        self.count += cnt
        self.total_s += tot
        if mx > self.max_s:
            self.max_s = mx

    def quantile(self, q: float) -> float:
        """Latency (seconds) at quantile q: upper bound of the bucket
        holding the q-th sample."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for b in sorted(self.buckets):
            seen += self.buckets[b]
            if seen >= rank:
                return (2.0 ** b) / 1e6
        return self.max_s

    def summary(self) -> dict:
        return {"count": self.count,
                "mean_s": round(self.total_s / self.count, 9)
                if self.count else 0.0,
                "max_s": round(self.max_s, 9),
                "p50_s": round(self.quantile(0.50), 9),
                "p95_s": round(self.quantile(0.95), 9),
                "p99_s": round(self.quantile(0.99), 9)}

    def to_dict(self) -> dict:
        """Wire form: what mon_collect ships so the collector can merge."""
        return {"buckets": {str(b): n for b, n in sorted(self.buckets.items())},
                "count": self.count,
                "total_s": round(self.total_s, 9),
                "max_s": round(self.max_s, 9)}


class TargetMetrics:
    """Per-target span sink: latency histograms keyed by op / export /
    jobid plus scalar roll-ups (queue wait, service time, seeks, bytes)."""

    def __init__(self, uuid: str):
        self.uuid = uuid
        self.by_op: dict[str, LatencyHistogram] = {}
        self.by_export: dict[str, LatencyHistogram] = {}
        self.by_jobid: dict[str, LatencyHistogram] = {}
        self.spans = 0
        self.queue_wait_s = 0.0
        self.service_s = 0.0
        self.seeks = 0
        self.nbytes = 0

    def record(self, op: str, export: str, jobid: str,
               queue_wait: float, service: float, seeks: int, nbytes: int):
        latency = queue_wait + service
        for table, key in ((self.by_op, op), (self.by_export, export),
                           (self.by_jobid, jobid or "(none)")):
            h = table.get(key)
            if h is None:
                h = table[key] = LatencyHistogram()
            h.record(latency)
        self.spans += 1
        self.queue_wait_s += queue_wait
        self.service_s += service
        self.seeks += seeks
        self.nbytes += nbytes

    def summary(self, max_exports: int = 32) -> dict:
        """Snapshot-tree form. by_jobid ships raw buckets (the collector
        merges them across targets for cluster-wide quantiles); by_export
        is capped to the busiest `max_exports` so a thousand-client
        target reports a bounded tree, not a megabyte of leaves."""
        exports = sorted(self.by_export.items(),
                         key=lambda kv: (-kv[1].count, kv[0]))
        return {
            "spans": self.spans,
            "queue_wait_s": round(self.queue_wait_s, 9),
            "service_s": round(self.service_s, 9),
            "seeks": self.seeks,
            "bytes": self.nbytes,
            "by_op": {k: h.summary() for k, h in sorted(self.by_op.items())},
            "by_jobid": {k: dict(h.summary(), **h.to_dict())
                         for k, h in sorted(self.by_jobid.items())},
            "by_export": {k: h.summary() for k, h in exports[:max_exports]},
            "exports_omitted": max(0, len(exports) - max_exports),
        }


class MetricsRegistry:
    """Simulator-wide span registry: per-target sinks + trace-id dedup.

    Dedup state is bounded: trace ids are monotonically increasing, and
    resend/replay only ever revisit *recent* ids (a client's in-flight
    window), so pruning the oldest half at `DEDUP_LIMIT` is safe.
    """

    DEDUP_LIMIT = 200_000

    def __init__(self):
        self.targets: dict[str, TargetMetrics] = {}
        self.dup_suppressed = 0
        self._seen: set[int] = set()
        self._seen_max = 0

    def record_span(self, target: str, op: str, export: str, jobid: str,
                    queue_wait: float, service: float, seeks: int,
                    nbytes: int, trace_id: int) -> bool:
        """Record one span; returns False (and counts it) for a duplicate
        delivery of an already-recorded trace id."""
        if trace_id in self._seen:
            self.dup_suppressed += 1
            return False
        self._seen.add(trace_id)
        if trace_id > self._seen_max:
            self._seen_max = trace_id
        if len(self._seen) > self.DEDUP_LIMIT:
            cut = self._seen_max - self.DEDUP_LIMIT // 2
            self._seen = {t for t in self._seen if t >= cut}
        tm = self.targets.get(target)
        if tm is None:
            tm = self.targets[target] = TargetMetrics(target)
        tm.record(op, export, jobid, queue_wait, service, seeks, nbytes)
        return True

    def target_summary(self, uuid: str, max_exports: int = 32) -> dict:
        tm = self.targets.get(uuid)
        if tm is None:
            return TargetMetrics(uuid).summary(max_exports)
        return tm.summary(max_exports)

    def info(self) -> dict:
        return {"targets": len(self.targets),
                "spans": sum(t.spans for t in self.targets.values()),
                "dup_suppressed": self.dup_suppressed}


def merge_jobid_histograms(target_summaries: list[dict]) -> dict:
    """Cluster-wide per-jobid latency: merge the by_jobid bucket arrays
    of many target summaries into one histogram per jobid and return
    {jobid: summary}. This is the MELT aggregation step — quantiles are
    computed AFTER the merge, never averaged across targets."""
    merged: dict[str, LatencyHistogram] = {}
    for ts in target_summaries:
        for jobid, h in (ts.get("by_jobid") or {}).items():
            m = merged.get(jobid)
            if m is None:
                m = merged[jobid] = LatencyHistogram()
            m.merge(h)
    return {jobid: h.summary() for jobid, h in sorted(merged.items())}
