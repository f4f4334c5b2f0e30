"""Recovery coordination (paper ch. 11, 29, §6.7.6).

  * Pinger: periodic health checks of critical targets + gateways
    (§4.4.2.5 'the lustre pinger is going to be checking the health of
    critical nodes anyway ... provides the back-stop').
  * Failover rings (§6.7.6.4): each target has an ordered nid list; the
    import walks it on reconnect (implemented in ptlrpc.Import) — here we
    provide the ring construction.
  * Consistent-cut snapshot for multi-MDS failures (§6.7.6.3): the leader
    collects last-committed transnos + dependency vectors and converges on
    a cut that could have been reached by full execution of client
    requests; MDSes roll back (undo records) past the cut.

The cut is also the changelog's cluster durability horizon: each MDS
tracks the highest cut it has been told about (or has derived itself by
running `compute_consistent_cut` over peer `dep_records`, see
`mds._gate_at_cluster_cut`) and `changelog_read` never serves a record
above it — so `rollback_after_failure` can never retract a record a
consumer has already seen. The steady-state `snapshot()` below pushes
the cut to every MDS through `prune_history`, advancing that horizon
without the serving path having to re-derive it.
"""
from __future__ import annotations

from typing import Iterable

from repro_torch.core import ptlrpc as R


class Pinger:
    """Client-side pinger over a set of imports (§4.4.2.5).

    Beyond the health back-stop, the pinger is the client half of the
    active health plane: a down→up transition on an import
    marks the OST active again in the LOV (and vice versa), and the
    ping itself notices a target's new boot count — imperative recovery,
    so the client reconnects/replays long before any request timeout.
    """

    def __init__(self, imports: Iterable[R.Import], interval: float = 0.5,
                 lov=None, on_down=None, on_up=None):
        self.imports = list(imports)
        self.interval = interval
        self.lov = lov
        self.on_down = on_down
        self.on_up = on_up
        self.down: set = set()

    def _mark(self, uuid: str, alive: bool) -> None:
        if alive:
            if uuid in self.down:
                self.down.discard(uuid)
                if self.lov is not None and uuid in self.lov.by_uuid:
                    self.lov.set_active(uuid, True)
                if self.on_up:
                    self.on_up(uuid)
        else:
            if uuid not in self.down:
                self.down.add(uuid)
                if self.lov is not None and uuid in self.lov.by_uuid:
                    self.lov.set_active(uuid, False)
                if self.on_down:
                    self.on_down(uuid)

    def tick(self) -> dict:
        """Ping everything once; returns {target_uuid: alive}."""
        out = {}
        for imp in self.imports:
            alive = imp.ping()
            out[imp.target_uuid] = alive
            self._mark(imp.target_uuid, alive)
        return out


def failover_ring(targets: list) -> dict[str, list[str]]:
    """§6.7.6.4: organize servers in a ring; the nearest working left
    neighbour is the failover node. Returns target_uuid -> nid list."""
    nids = {}
    n = len(targets)
    for i, t in enumerate(targets):
        ring = [targets[(i + k) % n].node.nid for k in range(n)]
        nids[t.uuid] = ring
    return nids


# ------------------------------------------------------- consistent cut

def compute_consistent_cut(states: dict[str, dict]) -> dict[str, int]:
    """§6.7.6.3 leader algorithm.

    `states[uuid] = {"committed": int, "deps": [(transno, {peer: pt})]}`.
    Start each cut at the last committed transno; while any included
    transaction depends on an excluded peer transaction, exclude it too.
    The sequence is strictly decreasing, hence converges.
    """
    cut = {u: s["committed"] for u, s in states.items()}
    changed = True
    while changed:
        changed = False
        for u, s in states.items():
            for transno, deps in s["deps"]:
                for peer, pt in deps.items():
                    if peer not in cut:
                        continue
                    # a multi-node transaction is in the snapshot on ALL
                    # nodes or on NONE (a half-rename is not "a state that
                    # could have been reached through full execution of
                    # requests")
                    if transno <= cut[u] and pt > cut[peer]:
                        cut[u] = min(cut[u], transno - 1)
                        changed = True
                    elif pt <= cut[peer] and transno > cut[u]:
                        cut[peer] = min(cut[peer], pt - 1)
                        changed = True
    return cut


class MdsClusterRecovery:
    """Leader-driven snapshot/rollback across the MDS cluster."""

    def __init__(self, rpc: R.RpcClient, mds_nids: dict[str, list[str]]):
        self.rpc = rpc
        self.imports = {u: rpc.import_target(u, nids, "mds")
                        for u, nids in mds_nids.items()}

    def collect(self) -> dict[str, dict]:
        out = {}
        for u, imp in self.imports.items():
            try:
                out[u] = imp.request("dep_records", {}).data
            except (R.TimeoutError_, R.RpcError):
                pass
        return out

    def snapshot(self) -> dict[str, int]:
        """Steady-state: advance the cluster-committed cut and let MDSes
        prune their retained undo history ('records can be canceled when
        the cluster as a whole has committed'). Each MDS also adopts the
        cut as its changelog serving horizon (`MdsTarget.cluster_cut`)."""
        cut = compute_consistent_cut(self.collect())
        for u, transno in cut.items():
            self.imports[u].request("prune_history", {"transno": transno})
        return cut

    def rollback_after_failure(self) -> dict[str, int]:
        """After simultaneous MDS failures: roll every surviving/restarted
        MDS back to a consistent cut; clients then drop replay requests
        older than the cut and replay the rest."""
        states = self.collect()
        cut = compute_consistent_cut(states)
        for u, transno in cut.items():
            self.imports[u].request("rollback_to", {"transno": transno})
        return cut
