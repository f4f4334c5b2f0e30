"""Simulation substrate: virtual clock, link model, fault injection, stats.

The whole Lustre cluster runs in-process and synchronously (handlers are
plain Python calls), while *time* is modelled analytically: every message
occupies its (src, dst) link for latency + bytes/bandwidth, and callers that
wait for N parallel completions advance the clock to max(completion times).
This gives deterministic, reproducible performance numbers for the
benchmarks (striping scaling, COBD read scaling, recovery time) without
threads.
"""
from __future__ import annotations

import dataclasses
import random
from collections import defaultdict


class Clock:
    """Virtual time in seconds."""

    def __init__(self):
        self.now = 0.0

    def advance_to(self, t: float) -> None:
        if t > self.now:
            self.now = t

    def advance(self, dt: float) -> None:
        self.now += dt


@dataclasses.dataclass
class LinkSpec:
    """One network type (NAL). Default numbers ~ GigE (socknal)."""
    latency: float = 50e-6          # per-message latency (s)
    bandwidth: float = 1e9          # bytes/s
    small_msg_cost: float = 5e-6    # per-message CPU/serialisation cost


# NAL presets from the paper's world: TCP (socknal), Quadrics Elan (qswnal).
NALS = {
    "socknal": LinkSpec(latency=50e-6, bandwidth=110e6),
    "qswnal": LinkSpec(latency=5e-6, bandwidth=340e6),
    "ibnal": LinkSpec(latency=7e-6, bandwidth=900e6),
    "lonal": LinkSpec(latency=1e-6, bandwidth=4e9),     # loopback
}


class FaultPlan:
    """Mutable fault-injection state consulted on every delivery."""

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.down_nids: set = set()          # dead nodes (drop all traffic)
        self.drop_prob: dict = {}            # (src,dst) or "*" -> prob
        self.partitions: set = set()         # frozenset({a, b}) cut pairs
        self.drop_next: defaultdict = defaultdict(int)  # nid -> count
        # per-link latency model (chaos harness): extra seconds added to
        # every hop on (src,dst), or "*" for the whole fabric — a slow
        # WAN link / congested switch, distinct from dropping traffic
        self.link_delay: dict = {}

    def should_drop(self, src, dst) -> bool:
        if src in self.down_nids or dst in self.down_nids:
            return True
        if frozenset((src, dst)) in self.partitions:
            return True
        if self.drop_next[dst] > 0:
            self.drop_next[dst] -= 1
            return True
        p = self.drop_prob.get((src, dst), self.drop_prob.get("*", 0.0))
        return p > 0 and self.rng.random() < p

    def extra_latency(self, src, dst) -> float:
        if not self.link_delay:
            return 0.0
        return self.link_delay.get((src, dst),
                                   self.link_delay.get("*", 0.0))

    def heal(self):
        """Clear every injected network fault (chaos `heal` event);
        down_nids is owned by Node.fail/restart and is left alone."""
        self.drop_prob.clear()
        self.partitions.clear()
        self.drop_next.clear()
        self.link_delay.clear()


class Stats:
    """Cluster-wide counters; benchmarks read these.

    Counters are ALSO namespaced by node uuid so the monitoring plane
    reports per-target numbers that sum to the cluster totals.
    Attribution is contextual: ``ptlrpc.Node._request_in`` pushes the
    serving target's uuid onto ``node_stack`` for the duration of the
    handler, so every count made while serving target X lands in X's
    namespace automatically (nested server->server RPCs re-attribute
    correctly because the inner target pushes on top).  Code running
    outside any service context (client-side caches) may pass an
    explicit ``node=`` fallback; counts with neither stay global-only.
    """

    def __init__(self):
        self.counters = defaultdict(int)
        self.bytes = defaultdict(int)
        self.node_counters = defaultdict(lambda: defaultdict(int))
        self.node_bytes = defaultdict(lambda: defaultdict(int))
        self.node_stack: list[str] = []   # serving-target uuid context

    def _node(self, fallback):
        return self.node_stack[-1] if self.node_stack else fallback

    def count(self, key: str, n: int = 1, node: str | None = None):
        self.counters[key] += n
        owner = self._node(node)
        if owner is not None:
            self.node_counters[owner][key] += n

    def add_bytes(self, key: str, n: int, node: str | None = None):
        self.bytes[key] += n
        owner = self._node(node)
        if owner is not None:
            self.node_bytes[owner][key] += n

    def snapshot(self) -> dict:
        return {"counters": dict(self.counters), "bytes": dict(self.bytes)}

    def node_snapshot(self, node: str) -> dict:
        return {"counters": dict(self.node_counters.get(node, {})),
                "bytes": dict(self.node_bytes.get(node, {}))}

    def reset(self):
        self.counters.clear()
        self.bytes.clear()
        self.node_counters.clear()
        self.node_bytes.clear()
        self.node_stack.clear()


class Simulator:
    """Shared context handed to every node: clock + faults + stats."""

    def __init__(self, seed: int = 0):
        self.clock = Clock()
        self.faults = FaultPlan(seed)
        self.stats = Stats()
        # RPC span registry (core.metrics): trace-id dedup lives HERE so
        # exactly-once accounting survives target crash/restart
        from repro_torch.core.metrics import MetricsRegistry
        self.metrics = MetricsRegistry()
        # OBD_FAIL failpoints are node-global (like obd_fail_loc); a fresh
        # simulator starts disarmed so clusters are isolated (core.fail)
        from repro_torch.core import fail as fail_mod
        self.fail = fail_mod.state
        self.fail.reset()
        self.fail.sim = self       # 'delay' actions advance this clock
        # runtime sanitizer (SIM_SANITIZE=1): like fail.state it is
        # module-global; per-sim graphs reset here so clusters are
        # isolated (client uuids repeat across clusters)
        from repro_torch.core import sanitize
        self.sanitize = sanitize.state
        sanitize.state.on_new_sim()

    @property
    def now(self) -> float:
        return self.clock.now

    def race(self, thunks):
        """Hedged execution: run all thunks from the same virtual instant
        and advance the clock to the FIRST completion (straggler
        mitigation — the loser's link stays busy, as in real hedging).
        Returns (winner_index, winner_result)."""
        t0 = self.clock.now
        results, ends = [], []
        for th in thunks:
            self.clock.now = t0
            results.append(th())
            ends.append(self.clock.now)
        best = min(range(len(ends)), key=lambda i: ends[i])
        self.clock.now = ends[best]
        self.stats.count("sim.hedged_race")
        return best, results[best]

    def parallel(self, thunks):
        """Run thunks as concurrent activities starting at the same virtual
        instant; the clock ends at the max completion time. Per-link busy
        times still serialise messages that share a link, so e.g. N stripe
        writes to N different OSTs overlap while N writes to ONE OST queue.
        """
        t0 = self.clock.now
        ends, results = [], []
        for th in thunks:
            self.clock.now = t0
            results.append(th())
            ends.append(self.clock.now)
        self.clock.now = max(ends) if ends else t0
        return results
