"""Seeded network-chaos harness.

Lustre's recovery machinery (adaptive timeouts, VBR, the pinger health
plane) exists because real fabrics drop, delay, and partition traffic
at the worst possible moments. This module generates deterministic
fault schedules over the simulator's analytic network model so tests
can subject a live workload to that weather and assert the durability
oracles afterwards. Six primitives:

  drop       lose the next N messages addressed to one nid
  lossy      probabilistic loss on one (src, dst) link or "*"
  delay      extra per-hop latency on one link or "*"
  partition  sever one node pair bidirectionally
  flap       power-cycle a server node (down until the next heal)
  heal       clear every injected fault and restart flapped servers

A schedule is a pure function of its integer seed (`random.Random`), so
any failing seed replays identically under the deterministic clock. The
`net.flap` fail site gates the flap primitive: arming it with drop or
crash suppresses the power-cycle, which is how the crash-point sweep
proves a *missing* flap changes nothing it shouldn't.
"""
from __future__ import annotations

import random
from typing import Iterable

from repro_torch.core import fail as fail_mod

EVENT_KINDS = ("drop", "lossy", "delay", "partition", "flap", "heal")

# chaos stays inside the envelope the recovery machinery is built for:
# loss below the retry horizon, delays below at_max, short partitions
MAX_DROP_BURST = 3
MAX_LOSS_PROB = 0.2
MAX_EXTRA_DELAY = 0.5


def generate_schedule(seed: int, steps: int, client_nids: Iterable[str],
                      server_names: Iterable[str], *,
                      heal_every: int = 4) -> list[tuple]:
    """Derive `steps` chaos events from `seed`. Every `heal_every`-th
    event is a forced heal so no schedule strands the cluster in a
    permanently-faulted state (the final event is always a heal, added
    by the runner if the schedule doesn't end with one)."""
    rng = random.Random(seed)
    clients = list(client_nids)
    servers = list(server_names)
    nids = clients + [f"elan:{s}" for s in servers]
    out: list[tuple] = []
    for i in range(steps):
        if heal_every and i % heal_every == heal_every - 1:
            out.append(("heal",))
            continue
        kind = rng.choice(("drop", "lossy", "delay", "partition", "flap"))
        if kind == "drop":
            out.append(("drop", rng.choice(nids),
                        rng.randint(1, MAX_DROP_BURST)))
        elif kind == "lossy":
            link = ("*" if rng.random() < 0.3
                    else (rng.choice(nids), rng.choice(nids)))
            out.append(("lossy", link,
                        round(rng.uniform(0.05, MAX_LOSS_PROB), 3)))
        elif kind == "delay":
            link = ("*" if rng.random() < 0.3
                    else (rng.choice(nids), rng.choice(nids)))
            out.append(("delay", link,
                        round(rng.uniform(0.05, MAX_EXTRA_DELAY), 3)))
        elif kind == "partition":
            a, b = rng.sample(nids, 2)
            out.append(("partition", a, b))
        else:
            out.append(("flap", rng.choice(servers)))
    if not out or out[-1][0] != "heal":
        out.append(("heal",))
    return out


class ChaosEngine:
    """Applies schedule events to a cluster, one per workload step."""

    def __init__(self, cluster, server_names: Iterable[str]):
        self.cluster = cluster
        self.sim = cluster.sim
        self.servers = list(server_names)
        self.flapped: set = set()         # names currently down via flap

    def apply(self, ev: tuple) -> None:
        kind = ev[0]
        f = self.sim.faults
        if kind == "drop":
            f.drop_next[ev[1]] += ev[2]
        elif kind == "lossy":
            f.drop_prob[ev[1]] = ev[2]
        elif kind == "delay":
            f.link_delay[ev[1]] = ev[2]
        elif kind == "partition":
            f.partitions.add(frozenset((ev[1], ev[2])))
        elif kind == "flap":
            if fail_mod.state.check("net.flap") in ("drop", "crash"):
                return                    # the flap itself is suppressed
            name = ev[1]
            if name not in self.flapped:
                self.cluster.fail_node(name)
                self.flapped.add(name)
        elif kind == "heal":
            self.heal()
        else:
            raise ValueError(f"unknown chaos event {kind!r}")
        self.sim.stats.count(f"chaos.{kind}")

    def heal(self) -> None:
        """Clear injected faults and power flapped servers back on —
        the state every schedule ends in before oracles run."""
        self.sim.faults.heal()
        for name in sorted(self.flapped):
            self.cluster.restart_node(name)
        self.flapped.clear()

    def run(self, schedule: list[tuple], step) -> int:
        """Interleave: one event, one workload step (a zero-arg callable
        that may raise RpcError/TimeoutError_ — chaos makes those legal).
        Ends healed. Returns how many steps raised."""
        from repro_torch.core import ptlrpc as R
        failures = 0
        for ev in schedule:
            self.apply(ev)
            try:
                step()
            except (R.RpcError, R.TimeoutError_):
                failures += 1
        self.heal()
        return failures
