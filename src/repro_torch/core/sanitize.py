"""Runtime protocol sanitizer: DLM lockdep + request-boundary invariants.

Enabled with ``SIM_SANITIZE=1`` (evaluated whenever a Simulator is
built, so one pytest run flips the whole suite), or force-enabled from
a test via :func:`forced`.  The hooks are no-ops when disabled — one
attribute check per event.

What it watches:

* **lockdep** — a lock-dependency graph built from *real* enqueue order
  across every client and MDS-MDS import.  An edge ``A -> B`` is
  recorded only when an owner that HOLDS ``A`` issues an enqueue for
  ``B`` that actually conflicts with another holder (true wait-for
  semantics: cached-but-compatible grants order nothing).  A cycle in
  that graph is an ABBA deadlock the synchronous simulator would never
  itself hang on — exactly why it needs a sanitizer.
* **exactly-once** — every transno-bearing handler execution is recorded
  per ``(target, client, xid)``; executing the same xid twice while the
  first execution's transaction survived (committed, or not yet crashed
  away) means the reply cache / replay barrier leaked a duplicate.
  ``Target.crash`` prunes executions above the committed cut: their
  replay is legitimate re-execution.
* **grant conservation** — at every OST request boundary: no export with
  negative grant, and the sum of outstanding grants never exceeds the
  backend capacity.
* **counter partition** — periodically (and whenever procfs asks): for
  every counter key, the per-node attributions must sum to at most the
  cluster-wide total (attribution can under-count — client-side counts
  carry no node — but must never over-count).

Violations are recorded, not raised, so one broken invariant cannot
cascade into unrelated test failures; the autouse pytest fixture in
``tests/conftest.py`` fails any test that produced new ones.  Tests
that *construct* violations on purpose wrap the scenario in
:func:`capture`.
"""
from __future__ import annotations

import dataclasses
import os
from collections import defaultdict
from contextlib import contextmanager

ENV_VAR = "SIM_SANITIZE"


def env_enabled() -> bool:
    return os.environ.get(ENV_VAR, "") not in ("", "0")


@dataclasses.dataclass
class Violation:
    kind: str          # "lockdep-abba" | "exactly-once" | "grant" | "counters"
    detail: str
    chain: list = dataclasses.field(default_factory=list)

    def render(self) -> str:
        out = f"[{self.kind}] {self.detail}"
        for hop in self.chain:
            out += f"\n    {hop}"
        return out


class SanitizerState:
    """Module-global sanitizer state (mirrors ``fail.state``): per-sim
    graphs reset with every Simulator, violation log accumulates so the
    per-test fixture can diff it."""

    def __init__(self):
        self.forced: bool | None = None     # tests override the env
        self.enabled = env_enabled()
        self.checks: defaultdict = defaultdict(int)
        self.suppressed = 0                 # violations eaten by capture()
        self.violations: list[Violation] = []
        self._capturing: list | None = None
        self._new_sim()

    # ------------------------------------------------------------ lifecycle
    def _new_sim(self):
        # owner uuid -> {(target_uuid, res_name): refcount}
        self.held: defaultdict = defaultdict(lambda: defaultdict(int))
        # lock-order edges A -> {B}; evidence remembers one witness each
        self.edges: defaultdict = defaultdict(set)
        self.evidence: dict = {}
        self.cycles: list[list] = []
        self._cycle_keys: set = set()
        # target_uuid -> {(client_uuid, xid): transno}
        self.executed: defaultdict = defaultdict(dict)
        self._boundaries = 0

    def on_new_sim(self):
        """Called from Simulator.__init__: fresh cluster, fresh graphs
        (client uuids repeat across clusters — stale held-state would
        fabricate edges)."""
        self.enabled = self.forced if self.forced is not None \
            else env_enabled()
        self._new_sim()

    # ------------------------------------------------------------ reporting
    def _violate(self, kind: str, detail: str, chain: list | None = None):
        v = Violation(kind, detail, chain or [])
        if self._capturing is not None:
            self.suppressed += 1
            self._capturing.append(v)
        else:
            self.violations.append(v)

    def info(self) -> dict:
        """procfs 'sanitizer' rollup."""
        return {
            "enabled": self.enabled,
            "checks": dict(self.checks),
            "violations": len(self.violations),
            "captured": self.suppressed,
            "lockdep": {
                "edges": sum(len(v) for v in self.edges.values()),
                "held_owners": sum(1 for h in self.held.values() if h),
                "cycles": len(self.cycles),
            },
        }

    # -------------------------------------------------------------- lockdep
    def note_granted(self, owner: str, key: tuple):
        if not self.enabled:
            return
        self.held[owner][key] += 1

    def note_released(self, owner: str, key: tuple):
        if not self.enabled:
            return
        h = self.held[owner]
        if h.get(key, 0) <= 1:
            h.pop(key, None)
        else:
            h[key] -= 1

    def note_enqueue(self, owner: str, key: tuple, conflicted: bool):
        """Server-side enqueue observation.  Only a CONFLICTING enqueue
        orders locks: the owner is now waiting on `key`'s holders while
        everything in its held set stays pinned."""
        if not self.enabled or not conflicted:
            return
        self.checks["lockdep.enqueue"] += 1
        for held_key in list(self.held.get(owner, ())):
            if held_key == key:
                continue
            new_edge = key not in self.edges[held_key]
            self.edges[held_key].add(key)
            self.evidence.setdefault((held_key, key), owner)
            if new_edge:
                self._check_cycle(held_key, key)

    def _check_cycle(self, src: tuple, dst: tuple):
        """Adding src->dst: a path dst ->* src closes a cycle."""
        path = self._find_path(dst, src)
        if path is None:
            return
        cycle = [src] + path            # src -> dst -> ... -> src
        sig = frozenset(cycle)
        if sig in self._cycle_keys:
            return
        self._cycle_keys.add(sig)
        self.cycles.append(cycle)
        chain = []
        for a, b in zip(cycle, cycle[1:]):
            who = self.evidence.get((a, b), "?")
            chain.append(f"{who} held {_fmt(a)} while waiting for {_fmt(b)}")
        self._violate(
            "lockdep-abba",
            f"lock-order cycle over {len(cycle) - 1} resource(s)", chain)

    def _find_path(self, src: tuple, dst: tuple):
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self.edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def lockdep_report(self) -> str:
        """Human-readable report (see core/README.md for how to read it)."""
        lines = [f"lockdep: {len(self.cycles)} cycle(s), "
                 f"{sum(len(v) for v in self.edges.values())} edge(s)"]
        for cycle in self.cycles:
            lines.append("  cycle: " + " -> ".join(_fmt(k) for k in cycle))
            for a, b in zip(cycle, cycle[1:]):
                who = self.evidence.get((a, b), "?")
                lines.append(f"    {who}: held {_fmt(a)}, wanted {_fmt(b)}")
        return "\n".join(lines)

    # --------------------------------------------------------- exactly-once
    def note_execute(self, target_uuid: str, client_uuid: str, xid: int,
                     transno: int):
        if not self.enabled:
            return
        self.checks["exactly_once.execute"] += 1
        slot = self.executed[target_uuid]
        prev = slot.get((client_uuid, xid))
        if prev is not None:
            self._violate(
                "exactly-once",
                f"{target_uuid} re-executed xid {xid} from {client_uuid} "
                f"(first run transno {prev} survived the crash cut, second "
                f"run got transno {transno}) — reply cache / replay "
                f"barrier leaked a duplicate execution")
        slot[(client_uuid, xid)] = transno

    def note_crash(self, target_uuid: str, committed_transno: int):
        """Uncommitted executions died with the journal: replaying them
        is the protocol working, not a duplicate."""
        if not self.enabled:
            return
        slot = self.executed[target_uuid]
        for k in [k for k, t in slot.items() if t > committed_transno]:
            del slot[k]

    # ---------------------------------------------------- boundary invariants
    def request_boundary(self, target):
        """Runs in Node._request_in's finally, after every served RPC."""
        if not self.enabled:
            return
        self._boundaries += 1
        obd = getattr(target, "obd", None)
        if obd is not None and target.exports:
            self.checks["grant.boundary"] += 1
            total = 0
            for uuid, exp in target.exports.items():
                g = exp.data.get("grant", 0)
                total += g
                if g < 0:
                    self._violate("grant",
                                  f"{target.uuid}: export {uuid} holds "
                                  f"negative grant {g}")
            cap = obd.statfs()["capacity"]
            if total > cap:
                self._violate("grant",
                              f"{target.uuid}: outstanding grant {total} "
                              f"exceeds capacity {cap} — grants are no "
                              f"longer conserved")
        if self._boundaries % 256 == 0:
            self.check_counter_partition(target.sim.stats)

    def check_counter_partition(self, stats):
        self.checks["counters.partition"] += 1
        sums: defaultdict = defaultdict(int)
        for per_node in stats.node_counters.values():
            for key, n in per_node.items():
                sums[key] += n
        for key, n in sums.items():
            total = stats.counters.get(key, 0)
            if n > total:
                self._violate(
                    "counters",
                    f"per-node counters for {key!r} sum to {n} but the "
                    f"cluster total is {total} — node attribution "
                    f"double-counted")


state = SanitizerState()


def _fmt(key: tuple) -> str:
    target_uuid, res = key
    return f"{target_uuid}:{res}"


# ------------------------------------------------------------- test helpers

@contextmanager
def forced(on: bool = True):
    """Force the sanitizer on (or off) regardless of SIM_SANITIZE; new
    Simulators built inside the scope inherit the forced setting."""
    prev_forced, prev_enabled = state.forced, state.enabled
    state.forced = on
    state.enabled = on
    try:
        yield state
    finally:
        state.forced, state.enabled = prev_forced, prev_enabled


@contextmanager
def capture():
    """Route violations produced inside the scope into the yielded list
    instead of the global log — for tests that stage violations on
    purpose (the autouse guard fixture stays green)."""
    prev = state._capturing
    state._capturing = caught = []
    try:
        yield caught
    finally:
        state._capturing = prev
