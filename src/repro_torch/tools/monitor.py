"""Cluster-wide monitoring plane (ORNL MELT + Arefin auditing papers).

Two consumers of the per-target instrumentation in ``core.metrics``:

* :class:`ClusterMonitor` — the MELT-style aggregation tree.  One
  collector client pulls a ``mon_collect`` leaf from EVERY MDS/OST over
  real, cost-bearing RPCs (single attempt, ``no_recover``) and merges
  them into one snapshot: per-target sections (NRS, DLM locks, grants,
  space, changelog, per-node counters, latency histograms) plus cluster
  roll-ups whose per-jobid quantiles come from *merging histogram
  buckets*, never from averaging per-target percentiles.  A crashed or
  partitioned target degrades the snapshot to ``partial`` with that
  target listed in ``stale`` — totals are computed over fresh leaves
  only, so they are never silently wrong, and the collector never hangs.
  The collector's own traffic is measured: every snapshot reports
  monitor RPCs as a fraction of workload RPCs (the ≤2% CI gate).

* :class:`ChangelogAnomalyDetector` — a changelog-stream consumer that
  tallies per-jobid operation rates per collection window and flags
  spikes against a rolling (EWMA) baseline: the auditing use-case that
  proves the plane sees real activity, tested with the noisy-neighbor
  personality of ``benchmarks/bench_scale.py``.
"""
from __future__ import annotations

from repro_torch.core import metrics as metrics_mod
from repro_torch.core import ptlrpc as R

MONITOR_JOBID = "monitor"


class ClusterMonitor:
    """Pull-based stats collector over ordinary ptlrpc imports.

    `max_exports` bounds the per-export section each target ships
    (busiest-N); `max_reconnects` bounds how long a dead target can
    stall collection (single-attempt requests + a short connect ring).
    """

    def __init__(self, cluster, node: R.Node | None = None,
                 max_exports: int = 32):
        self.cluster = cluster
        self.sim = cluster.sim
        self.max_exports = max_exports
        node = node or cluster.client_nodes[0]
        self.rpc = R.RpcClient(node)
        self.rpc.jobid = MONITOR_JOBID   # collector traffic is visible
        self.imports: dict[str, R.Import] = {}
        self.snapshots = 0
        for t in cluster.mds_targets:
            self._import(t.uuid, cluster.mds_nids[t.uuid], "mds")
        for t in cluster.ost_targets:
            self._import(t.uuid, cluster.ost_nids[t.uuid], "ost")

    def _import(self, uuid: str, nids, kind: str):
        imp = self.rpc.import_target(uuid, nids, kind)
        imp.max_reconnects = 2        # a dead target costs 2 timeouts, max
        self.imports[uuid] = imp

    # ------------------------------------------------------------ collect
    def _pull(self, uuid: str) -> dict:
        imp = self.imports[uuid]
        try:
            rep = imp.request("mon_collect",
                              {"max_exports": self.max_exports},
                              no_recover=True)
            return dict(rep.data, stale=False)
        except (R.TimeoutError_, R.RpcError):
            # crashed/partitioned target: this leaf is STALE — the
            # snapshot stays partial rather than hanging or guessing
            imp.state = "DISCONN"
            return {"uuid": uuid, "stale": True}

    def _monitor_rpcs(self) -> int:
        cnt = self.sim.stats.counters
        return (cnt.get("rpc.mds.mon_collect", 0)
                + cnt.get("rpc.ost.mon_collect", 0))

    def collect(self) -> dict:
        """One aggregation round: every target's leaf -> ONE tree."""
        t0 = self.sim.now
        mon0 = self._monitor_rpcs()
        leaves = {u: self._pull(u) for u in self.imports}
        fresh = [d for d in leaves.values() if not d["stale"]]
        stale = sorted(u for u, d in leaves.items() if d["stale"])

        def total(path, default=0):
            out = default
            for d in fresh:
                v = d
                for p in path:
                    v = v.get(p) if isinstance(v, dict) else None
                    if v is None:
                        break
                if v is not None:
                    out += v
            return out

        counters = {}
        for d in fresh:
            for k, v in (d.get("counters") or {}).items():
                counters[k] = counters.get(k, 0) + v
        cluster = {
            "counters": counters,
            "locks": {k: total(("locks", k)) for k in
                      ("resources", "granted", "waiting")},
            "grant": {"granted_total": total(("grant", "granted_total")),
                      "shrunk_bytes": total(("grant", "shrunk_bytes"))},
            "space": {"capacity": total(("space", "capacity")),
                      "free": total(("space", "free"))},
            "changelog": {
                "records": total(("changelog", "records")),
                "users": sum(len(d.get("changelog", {}).get("users", {}))
                             for d in fresh),
            },
            "spans": total(("latency", "spans")),
            "by_jobid": metrics_mod.merge_jobid_histograms(
                [d["latency"] for d in fresh if "latency" in d]),
        }
        self.snapshots += 1
        mon_rpcs = self._monitor_rpcs()
        all_rpcs = sum(n for k, n in self.sim.stats.counters.items()
                       if k.startswith("rpc.") and not
                       k.endswith(".mon_collect") and
                       k not in ("rpc.timeout", "rpc.replay",
                                 "rpc.reply_cache_hit"))
        snap = {
            "ts": round(self.sim.now, 6),
            "collect_vtime_s": round(self.sim.now - t0, 6),
            "partial": bool(stale),
            "stale": stale,
            "targets": {u: leaves[u] for u in sorted(leaves)},
            "cluster": cluster,
            "overhead": {
                "snapshot_rpcs": mon_rpcs - mon0,
                "monitor_rpcs_total": mon_rpcs,
                "workload_rpcs_total": all_rpcs,
                "ratio": round(mon_rpcs / all_rpcs, 6) if all_rpcs else 0.0,
            },
        }
        self.sim.stats.count("mon.snapshot")
        if stale:
            self.sim.stats.count("mon.snapshot_partial")
        self._last = snap
        return snap

    def info(self) -> dict:
        """procfs summary: last-snapshot shape without the whole tree."""
        last = getattr(self, "_last", None)
        out = {"snapshots": self.snapshots}
        if last is not None:
            out.update(ts=last["ts"], partial=last["partial"],
                       stale=last["stale"],
                       overhead_ratio=last["overhead"]["ratio"])
        return out


class ChangelogAnomalyDetector:
    """Per-jobid op-rate spike detection over the changelog streams.

    Registers a consumer on every MDT and, per :meth:`poll`, tallies the
    new records by jobid. A jobid is flagged when its window count
    exceeds ``spike_factor`` x its rolling EWMA baseline (and a noise
    floor ``min_ops``). The baseline only absorbs the window AFTER the
    comparison — a spike cannot vaccinate itself.
    """

    def __init__(self, cluster, monitor: ClusterMonitor | None = None,
                 spike_factor: float = 4.0, min_ops: int = 16,
                 alpha: float = 0.3):
        self.cluster = cluster
        self.spike_factor = spike_factor
        self.min_ops = min_ops
        self.alpha = alpha
        self.baseline: dict[str, float] = {}    # jobid -> EWMA ops/window
        self.windows = 0
        self.anomalies: list[dict] = []
        # consume over the monitor's rpc client (one observability plane)
        self.rpc = monitor.rpc if monitor else ClusterMonitor(cluster).rpc
        self.users: dict[str, str] = {}
        self.read_idx: dict[str, int] = {}
        for uuid in cluster.mds_nids:
            self.users[uuid] = cluster.lctl("changelog_register", uuid)
            self.read_idx[uuid] = 0

    def poll(self) -> list[dict]:
        """Consume new records, close one window, return new anomalies."""
        tally: dict[str, int] = {}
        for uuid in self.users:
            t = self.cluster.target(uuid)
            recs = t.changelog.read(since_idx=self.read_idx[uuid])
            for rec in recs:
                self.read_idx[uuid] = max(self.read_idx[uuid], rec.idx)
                jid = rec.jobid or "(none)"
                tally[jid] = tally.get(jid, 0) + 1
            if recs:
                t.changelog.clear(self.users[uuid], self.read_idx[uuid])
        self.windows += 1
        flagged = []
        for jid, n in sorted(tally.items()):
            base = self.baseline.get(jid)
            if base is not None and n >= self.min_ops \
                    and n > self.spike_factor * base:
                flagged.append({"jobid": jid, "ops": n,
                                "baseline": round(base, 3),
                                "window": self.windows})
                self.cluster.stats.count("mon.anomaly")
            # EWMA update AFTER the spike test
            self.baseline[jid] = (n if base is None
                                  else (1 - self.alpha) * base
                                  + self.alpha * n)
        self.anomalies.extend(flagged)
        return flagged

    def close(self):
        for uuid, user in self.users.items():
            self.cluster.lctl("changelog_deregister", uuid, user)
        self.users.clear()
