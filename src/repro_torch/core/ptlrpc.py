"""ptlrpc: request processing over Portals (paper ch. 4.5-4.8, 22, 23, 29).

Concepts kept from the paper:
  * static portal assignment per protocol (OST_REQUEST_PORTAL=6, ...);
  * per-connection increasing xids; replies matched on xid bits;
  * bulk transfer via logical niobufs (vectors of extents) moved on the bulk
    portals, driven by the server (`ptlrpc_bulk_get` for writes / `_put` for
    reads);
  * targets / exports / imports / services (§4.6): an export is server-side
    per-client state (last_rcvd slot, reply cache); an import is the client
    stub with a failover nid list;
  * transactions: every update gets a transno; the server retains an *undo
    record* until commit (commits are lazy — `commit_interval` ops — so a
    crash loses the tail, which clients recover by REPLAY);
  * recovery (§6.6, ch. 11/29): timeout -> disconnect -> reconnect (possibly
    to a failover nid) -> replay committed-but-lost transnos in order ->
    resend unreplied requests; the server answers resends of executed
    requests from the reply cache keyed (client_uuid, xid).

Portal / NRS layering (ch. 22-23 + the NRS refactor):

    client Import.request()                 server Node
      |  PUT on REQUEST_PORTALS[kind]        |  pre-posted MD, EQ handler
      v                                      v
    portals.transmit  ------------------>  Node._request_in(ev)
                                             |  target lookup (body._target)
                                             v
                                           Service.process(req, arrival)
                                             |  NRS policy picks the virtual
                                             |  start (fifo/crr/orr/tbf,
                                             |  see core.nrs) + accounting
                                             v
                                           Target.handle(req)  -> Reply
                                             |
      reply MD matched on xid  <-----------  PUT on REPLY_PORTALS[kind]

The Service sits between the Portals event and the Target handler table:
every target owns one (`target.service`), its policy is switchable at
runtime (`service.set_policy("tbf", rate=100)` or `lctl("nrs", ...)`),
and bulk-heavy requests (niobuf vectors from the OSC's BRW path) are
charged a per-niobuf service cost so scheduling sees their true weight.
"""
from __future__ import annotations

import dataclasses
import itertools
import zlib
from collections import defaultdict
from typing import Any, Callable, Optional

from repro_torch.core import fail as fail_mod
from repro_torch.core import nrs as nrs_mod
from repro_torch.core import portals as P
from repro_torch.core import sanitize
from repro_torch.core.sim import Simulator

# --------------------------------------------------------------- portals
# Static portal index assignment (paper §4.5.1).
OSC_REPLY_PORTAL = 4
OSC_BULK_PORTAL = 5
OST_REQUEST_PORTAL = 6
OST_BULK_PORTAL = 8
MDC_REPLY_PORTAL = 10
MDS_REQUEST_PORTAL = 12
MDS_BULK_PORTAL = 13
LDLM_CB_REQUEST_PORTAL = 15   # server -> client ASTs
LDLM_CB_REPLY_PORTAL = 16
LDLM_REQUEST_PORTAL = 17
LDLM_REPLY_PORTAL = 18
PING_PORTAL = 23

PAGE_SIZE = 4096               # BRW page granularity (cost model + OSC)

REQUEST_PORTALS = {"ost": OST_REQUEST_PORTAL, "mds": MDS_REQUEST_PORTAL,
                   "ldlm": LDLM_REQUEST_PORTAL, "ping": PING_PORTAL,
                   "ldlm_cb": LDLM_CB_REQUEST_PORTAL}
REPLY_PORTALS = {"ost": OSC_REPLY_PORTAL, "mds": MDC_REPLY_PORTAL,
                 "ldlm": LDLM_REPLY_PORTAL, "ping": OSC_REPLY_PORTAL,
                 "ldlm_cb": LDLM_CB_REPLY_PORTAL}

DEFAULT_TIMEOUT = 1.0      # virtual seconds ("obd_timeout")

# ------------------------------------------------- adaptive timeouts (AT)
# Lustre 1.8 adaptive timeouts (ch. 11): the client keeps a per-(import,
# opcode) service-time history (a decayed max) and times out at
# estimate * (1 + margin) clamped to [at_min, at_max] instead of the one
# flat obd_timeout.  The server side of the bargain is the EARLY REPLY:
# when the NRS queue means a request will finish after the client's
# shipped deadline, the service extends that deadline (`early_until` on
# the reply) so a merely-loaded server is not mistaken for a dead one.
AT_MIN = 0.5               # floor: never flakier than this
AT_MAX = 10.0              # ceiling: a dead server is still detected
AT_DECAY = 0.9             # history decay per observation (decayed max)
AT_MARGIN = 0.25           # client slack factor over the estimate
EARLY_REPLY_MARGIN = 0.25  # server slack granted past actual completion
BACKOFF_BASE = 0.05        # reconnect backoff: base * 2^attempt ...
BACKOFF_MAX = 1.0          # ... capped here (virtual seconds)
TRANSNO_EPOCH = 1 << 20    # per-boot transno epoch (VBR monotonicity)


class AdaptiveTimeout:
    """Per-import AT state: opcode -> decayed-max service estimate."""

    def __init__(self, at_min: float = AT_MIN, at_max: float = AT_MAX,
                 enabled: bool = True):
        self.at_min = at_min
        self.at_max = at_max
        self.enabled = enabled
        self.est: dict[str, float] = {}

    def observe(self, opcode: str, rtt: float):
        cur = self.est.get(opcode, 0.0)
        self.est[opcode] = max(rtt, cur * AT_DECAY)

    def timeout_for(self, opcode: str) -> float:
        est = self.est.get(opcode, 0.0)
        return min(self.at_max,
                   max(self.at_min, est * (1.0 + AT_MARGIN)))

    def info(self) -> dict:
        return {"at_min": self.at_min, "at_max": self.at_max,
                "enabled": self.enabled,
                "estimates": {k: round(v, 6)
                              for k, v in sorted(self.est.items())}}


def wire_size(obj: Any) -> int:
    """Rough on-the-wire size of a request/reply payload."""
    if obj is None:
        return 0
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    if isinstance(obj, str):
        return len(obj)
    if isinstance(obj, (int, float, bool)):
        return 8
    if isinstance(obj, dict):
        return 16 + sum(wire_size(k) + wire_size(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple, set)):
        return 16 + sum(wire_size(v) for v in obj)
    if dataclasses.is_dataclass(obj):
        return 16 + sum(wire_size(getattr(obj, f.name))
                        for f in dataclasses.fields(obj))
    return 32


# --------------------------------------------------------------- messages

@dataclasses.dataclass
class Request:
    opcode: str
    body: dict
    xid: int = 0
    client_uuid: str = ""
    boot_count: int = 0          # client boot count (epoch)
    conn_generation: int = 0
    replay: bool = False
    bulk_nbytes: int = 0         # niobuf vector total (timing)
    transno: int = 0             # assigned by server on updates
    sent_at: float = 0.0         # client send instant (AT: the server
                                 # derives request transit from it)
    deadline: float = 0.0        # client's absolute give-up time; the
                                 # server grants an early reply when its
                                 # own completion estimate overruns it
                                 # (0 = pre-AT client, never early-reply)
    jobid: str = ""              # batch-job tag: TBF NRS classification +
                                 # changelog attribution (one plumbing,
                                 # two consumers)
    trace_id: int = 0            # span id (core.metrics): assigned ONCE at
                                 # construction, stable across resend /
                                 # replay / reply-cache retries so the
                                 # registry can dedup to exactly one span


_trace_seq = itertools.count(1)   # cluster-wide span ids (0 = untraced)


@dataclasses.dataclass
class Reply:
    status: int = 0              # 0 ok, else -errno
    data: Any = None
    transno: int = 0
    last_committed: int = 0
    bulk: Any = None             # payload moved on the bulk portal
    bulk_nbytes: int = 0
    early_until: float = 0.0     # AT early reply: server-extended client
                                 # deadline (0 = no extension granted)
    pre_versions: Any = None     # VBR: [(key, version)] observed by this
                                 # update pre-op; the client pins them
                                 # into the retained request so a replay
                                 # can prove it still applies (§29 + VBR)


class RpcError(Exception):
    def __init__(self, status: int, msg: str = ""):
        super().__init__(f"rpc error {status} {msg}")
        self.status = status


class TimeoutError_(Exception):
    pass


# ----------------------------------------------------------------- export

@dataclasses.dataclass
class Export:
    """Server-resident per-client state (§4.6.5). `last_rcvd` slot + reply
    cache survive server restart (they are journalled with the transaction
    they belong to — we keep the committed prefix only)."""
    client_uuid: str
    client_nid: str
    conn_generation: int = 1
    boot_count: int = 0
    last_xid: int = 0
    # committed reply cache: xid -> Reply (persistent)
    reply_cache: dict = dataclasses.field(default_factory=dict)
    # uncommitted portion (lost on crash)
    volatile_replies: dict = dataclasses.field(default_factory=dict)
    data: dict = dataclasses.field(default_factory=dict)  # per-svc (opens..)
    last_ping: float = 0.0       # any RPC refreshes it; the server-side
                                 # pinger back-stop evicts exports whose
                                 # age exceeds ping_evict_age (§4.4.2.5)


# ---------------------------------------------------------------- service

class Service:
    """Request-processing service for one target (ch. 22-23).

    The seed's ad-hoc service loop (portals event -> handler, strictly in
    arrival order) is extracted here and given a pluggable Network Request
    Scheduler: the policy decides the virtual instant the service thread
    picks a request up, then the handler runs and the reply departs no
    earlier than start + service cost.  Costs model per-request CPU plus
    per-niobuf overhead so vectored BRW requests are weighted fairly.
    """

    def __init__(self, target: "Target", policy: str = "fifo",
                 cpu_cost: float = 5e-6, seek_cost: float = 4e-5,
                 page_cost: float = 5e-7, **params):
        self.target = target
        self.sim = target.sim
        self.cpu_cost = cpu_cost
        self.seek_cost = seek_cost     # per discontiguous niobuf run
        self.page_cost = page_cost     # per 4 KiB page transferred
        self.policy: nrs_mod.NrsPolicy = nrs_mod.make_policy(
            policy, self.sim, **params)

    def set_policy(self, name: str, **params):
        """Switch the NRS policy at runtime (lctl nrs ...); accounting
        restarts with the new policy."""
        self.policy = nrs_mod.make_policy(name, self.sim, **params)
        return self.policy

    @staticmethod
    def _nio_len(n: dict) -> int:
        d = n.get("data")
        return len(d) if d is not None else n.get("length", 0)

    def cost_parts(self, req: Request) -> tuple[float, int, int]:
        """Seek-aware scatter/gather service cost (§4.5.6): a *contiguous*
        run of niobufs is one disk seek plus per-page transfer, every
        discontiguity charges another seek — so NRS scheduling (and the
        benchmarks) see a scattered vector's true weight, not a flat
        per-niobuf constant. Returns (cost, seeks, payload_bytes) so the
        span recorded for this request carries its true disk weight."""
        nio = req.body.get("niobufs")
        if not isinstance(nio, (list, tuple)) or not nio:
            if "data" in req.body or "length" in req.body:
                # legacy single-extent BRW: one run
                ln = self._nio_len(req.body)
                pages = max(1, (ln + PAGE_SIZE - 1) // PAGE_SIZE)
                return (self.cpu_cost + self.seek_cost +
                        self.page_cost * pages, 1, ln)
            return self.cpu_cost, 0, 0
        runs, pages, nbytes, prev_end = 0, 0, 0, None
        for n in sorted(nio, key=lambda n: n.get("offset", 0)):
            ln = self._nio_len(n)
            nbytes += ln
            pages += max(1, (ln + PAGE_SIZE - 1) // PAGE_SIZE)
            off = n.get("offset", 0)
            if prev_end is None or off != prev_end:
                runs += 1              # discontiguity: the head seeks
            prev_end = off + ln
        self.sim.stats.count("nrs.seeks", runs)
        return (self.cpu_cost + self.seek_cost * runs +
                self.page_cost * pages, runs, nbytes)

    def request_cost(self, req: Request) -> float:
        return self.cost_parts(req)[0]

    def process(self, req: Request, arrival: float) -> Reply:
        cost, seeks, nio_bytes = self.cost_parts(req)
        start = self.policy.schedule(req, arrival, cost)
        self.sim.clock.advance_to(start)
        reply = self.target.handle(req)
        # the reply departs no earlier than the scheduled completion
        # (handlers issuing nested RPCs may already be later than this)
        self.sim.clock.advance_to(start + cost)
        if req.deadline and self.target.at_enabled \
                and self.sim.now + EARLY_REPLY_MARGIN > req.deadline:
            # AT early reply (ch. 11): queueing/service overran (or is
            # about to overrun) the client's deadline — extend it past
            # our completion plus the observed request transit, so the
            # reply's symmetric trip home still lands inside the grant
            fail_mod.maybe_fail("ptl.early_reply")
            net = max(0.0, arrival - req.sent_at) if req.sent_at else 0.0
            reply.early_until = max(reply.early_until,
                                    self.sim.now + net
                                    + EARLY_REPLY_MARGIN)
            self.sim.stats.count("rpc.early_reply")
        if req.trace_id and req.opcode not in nrs_mod.CONTROL_OPS \
                and reply.status not in (-11, -108, -107):
            # one span per traced RPC (ch. 35 observability): the registry
            # dedups on trace_id, so resends / replays / reply-cache-served
            # retries of this request never produce a second sample; the
            # excluded statuses are recovery gates the client retries
            # through — the span belongs to the attempt that executes
            self.sim.metrics.record_span(
                target=self.target.uuid, op=req.opcode,
                export=req.client_uuid, jobid=req.jobid,
                queue_wait=start - arrival, service=cost, seeks=seeks,
                nbytes=nio_bytes + req.bulk_nbytes + reply.bulk_nbytes,
                trace_id=req.trace_id)
        return reply


# ----------------------------------------------------------------- target

class Target:
    """A service target: handler table + transaction/undo machinery.

    Subclasses (OST, MDS, DLM namespace holder) register ops in self.ops and
    call `self.txn(undo_fn)` inside update handlers.
    """

    svc_kind = "ost"             # request portal selector

    def __init__(self, uuid: str, node: "Node"):
        self.uuid = uuid
        self.node = node
        self.sim = node.sim
        self.ops: dict[str, Callable] = {}
        self.exports: dict[str, Export] = {}
        self.transno = 0
        self.committed_transno = 0
        self.undo_log: list[tuple[int, Callable]] = []
        self.commit_interval = 64          # ops between lazy commits
        self._ops_since_commit = 0
        self.boot_count = 1
        self.recovering = False
        self.recovery_deadline = 0.0
        self._recov_pending: set = set()
        self.commit_callbacks: list[Callable[[int], None]] = []
        self.evicted: set = set()
        # ---- recovery-robustness knobs ----
        self.at_enabled = True             # server grants early replies
        self.recovery_per_client = 0.1     # window scales with exports
        self.recovery_window_max = 30.0
        self.ping_evict_age = 0.0          # 0 = server pinger backstop off
        self._next_stale_scan = 0.0
        # VBR (§29 + Lustre 1.8 version-based recovery): object key ->
        # mutation history as a list of transnos (last entry = current
        # version). Histories are pruned with the journal: a crash drops
        # entries above committed_transno, a consistent-cut rollback
        # drops entries above the cut.
        self.versions: dict[Any, list[int]] = {}
        self._replay_tno = 0               # replay reuses its original
                                           # transno (keeps the version
                                           # namespace crash-aligned)
        self.service = Service(self)
        self.ops["connect"] = self.op_connect
        self.ops["disconnect"] = self.op_disconnect
        self.ops["ping"] = self.op_ping
        self.ops["mon_collect"] = self.op_mon_collect
        self.ops["recovery_close"] = self.op_recovery_close
        node.register_target(self)

    # ------------------------------------------------------------- wiring
    def export_for(self, client_uuid: str, client_nid: str) -> Export:
        exp = self.exports.get(client_uuid)
        if exp is None:
            exp = Export(client_uuid, client_nid)
            self.exports[client_uuid] = exp
        return exp

    # -------------------------------------------------------------- txns
    def txn(self, undo: Callable[[], None]) -> int:
        """Open+record a transaction; returns its transno."""
        if self._replay_tno:
            # replay reuses the original transno (§29.2): VBR pre-op
            # versions reference transnos, so re-execution must not
            # renumber history or the next replay's match breaks.  The
            # counter itself never regresses: post-restart transnos live
            # in a fresh boot epoch above every number the crash lost
            tno = self._replay_tno
            self._replay_tno = 0           # only the op's first txn
            self.transno = max(self.transno, tno)
        else:
            self.transno += 1
            tno = self.transno
        self.undo_log.append((tno, undo))
        # deferred crash site ({mds,ost}.txn): the induced crash lands at
        # this target's request boundary — transaction atomicity
        fail_mod.note(f"{self.svc_kind}.txn")
        self._ops_since_commit += 1
        if self._ops_since_commit >= self.commit_interval:
            self.commit()
        return tno

    def commit(self):
        """Flush journal: everything up to `transno` becomes persistent."""
        fail_mod.maybe_fail(f"{self.svc_kind}.commit.before")
        self.committed_transno = self.transno
        self.undo_log.clear()
        self._ops_since_commit = 0
        for exp in self.exports.values():
            exp.reply_cache.update(exp.volatile_replies)
            exp.volatile_replies.clear()
            # bound the cache: a client only ever resends its last window
            if len(exp.reply_cache) > 512:
                for k in sorted(exp.reply_cache)[:-256]:
                    del exp.reply_cache[k]
        for cb in self.commit_callbacks:
            cb(self.committed_transno)
        self.sim.stats.count(f"{self.uuid}.commit")
        # "commit durable, reply lost": deferred to the request boundary,
        # AFTER the reply landed in the journaled reply cache — real
        # Lustre writes the last_rcvd reply slot inside the transaction,
        # so a resend after this crash is answered from the cache
        fail_mod.note(f"{self.svc_kind}.commit.after")

    def crash(self):
        """Lose uncommitted state: run undo records in reverse (§6.7.6.3
        'metadata undo log records')."""
        for transno, undo in reversed(self.undo_log):
            undo()
        # executions above the cut died with the journal: their replay
        # is legitimate re-execution, not an exactly-once violation
        sanitize.state.note_crash(self.uuid, self.committed_transno)
        self.transno = self.committed_transno
        self.undo_log.clear()
        self._ops_since_commit = 0
        self.vbr_prune(self.committed_transno)
        for exp in self.exports.values():
            exp.volatile_replies.clear()

    def restart(self):
        self.boot_count += 1
        # VBR keys versions by transno, so transnos must stay monotone
        # ACROSS reboots: a post-restart op reusing a number the crash
        # lost would collide with pinned replay transnos and poison the
        # version store (false conflicts on late replay).  Real servers
        # keep a per-boot epoch in the transno high bits; jump epochs
        self.transno = (self.transno // TRANSNO_EPOCH + 1) * TRANSNO_EPOCH
        # all live connections died with the node: clients must reconnect
        # (stale-generation requests bounce with -108 below)
        for exp in self.exports.values():
            exp.conn_generation += 1
        if self.exports:
            self.recovering = True
            self._recov_pending = set(self.exports)
            # window scaled to the client count (ch. 11): every export
            # needs a chance to reconnect+replay, but VBR means missing
            # the window is survivable, so the cap stays tight
            window = min(self.recovery_window_max,
                         2 * DEFAULT_TIMEOUT
                         + self.recovery_per_client * len(self.exports))
            self.recovery_deadline = self.sim.now + window
        self.on_restart()

    def on_restart(self):
        pass

    def finish_recovery(self):
        self.recovering = False

    def close_recovery(self):
        """Close the recovery window (§29.3 + VBR).  Unlike the pre-VBR
        scheme, stragglers are NOT blanket-evicted here: a client that
        reconnects after the close gets its replays version-checked like
        anyone else (delayed recovery) and is only evicted if a replay
        genuinely conflicts with the gap it left."""
        if not self.recovering:
            return
        if self.svc_kind == "mds":
            fail_mod.maybe_fail("mds.recovery_window")
        if self._recov_pending:
            self.sim.stats.count("rpc.recovery_stragglers",
                                 len(self._recov_pending))
        self._recov_pending = set()
        self.finish_recovery()

    def op_recovery_close(self, req: Request) -> Reply:
        """lctl abort_recovery analogue: the consistent-cut machinery (or
        an admin) closes the window early once every returning client has
        replayed — new requests unblock without waiting out the clock."""
        self.close_recovery()
        return Reply(data={"recovering": self.recovering})

    # ------------------------------------------------------ VBR versions
    def vbr_keys_for(self, req: Request) -> list:
        """Subclass hook: the object keys this update mutates (inode fids
        on the MDS, (group, oid) objects on the OST). Empty = the op is
        not version-tracked."""
        return []

    def version_of(self, key) -> int:
        hist = self.versions.get(key)
        return hist[-1] if hist else 0

    def vbr_prune(self, cut: int):
        """Drop version history above `cut` (crash / consistent-cut
        rollback): those mutations were undone with the journal tail."""
        if not self.versions:
            return
        for key in list(self.versions):
            hist = [t for t in self.versions[key] if t <= cut]
            if hist:
                self.versions[key] = hist
            else:
                del self.versions[key]

    def _vbr_admit(self, req: Request, exp: Export) -> Optional[Reply]:
        """Version-based replay admission: the replay shipped the pre-op
        versions it observed; if any tracked object has moved past them
        (a straggler's lost mutation was undone, or a later mutation
        already re-applied), re-executing would corrupt — evict THIS
        client, not every straggler."""
        vbr = req.body.get("_vbr")
        if not vbr:
            return None                    # pre-VBR request: admit as-is
        for key, ver in vbr:
            have = self.version_of(key)
            if have != ver:
                self.sim.stats.count("rpc.vbr_eviction")
                self.evict_client(req.client_uuid, reason="vbr",
                                  counted=True)
                return Reply(status=-107)
        self.sim.stats.count("rpc.vbr_admit")
        return None

    # --------------------------------------------------------- evictions
    def evict_client(self, uuid: str, reason: str = "admin",
                     counted: bool = False):
        """Evict one export, reclaiming what the server granted it: DLM
        locks through the existing ldlm eviction path, OST grant by
        zeroing the export's share."""
        if uuid in self.evicted or uuid not in self.exports:
            return
        if not counted:
            self.sim.stats.count(f"rpc.{reason}_eviction")
        self.evicted.add(uuid)
        exp = self.exports.get(uuid)
        if exp is not None:
            exp.data.pop("grant", None)
        ldlm = getattr(self, "ldlm", None)
        if ldlm is not None:
            ldlm.evict_client(uuid)
        self._recov_pending.discard(uuid)

    def _maybe_evict_stale(self, requester: str):
        """Server-side pinger back-stop (§4.4.2.5): exports whose last
        ping is older than ping_evict_age are dead — reclaim their locks
        and grant so the living stop waiting on them."""
        age = self.ping_evict_age
        if not age or self.sim.now < self._next_stale_scan:
            return
        self._next_stale_scan = self.sim.now + age / 4
        for uuid, exp in list(self.exports.items()):
            if uuid == requester or uuid in self.evicted:
                continue
            if exp.last_ping and self.sim.now - exp.last_ping > age:
                self.evict_client(uuid, reason="ping")

    # ------------------------------------------------------------ handler
    def handle(self, req: Request) -> Reply:
        st = self.sim.stats
        st.count(f"rpc.{self.svc_kind}.{req.opcode}")
        exp = self.export_for(req.client_uuid, "")
        exp.last_ping = self.sim.now       # any RPC is proof of life
        self._maybe_evict_stale(req.client_uuid)
        if req.client_uuid in self.evicted and req.opcode != "connect":
            return Reply(status=-107)      # ENOTCONN: evicted
        if (req.opcode not in ("connect", "disconnect", "ping")
                and not req.replay
                and req.conn_generation != exp.conn_generation):
            # connection died with a server reboot: force reconnect+replay
            return Reply(status=-108)
        # resend of an already-executed request? answer from reply cache.
        cached = exp.reply_cache.get(req.xid, exp.volatile_replies.get(req.xid))
        if cached is not None and not req.replay:
            st.count("rpc.reply_cache_hit")
            return cached
        if self.recovering and self.sim.now >= self.recovery_deadline:
            # window expired: close it — VBR version checks (not blanket
            # eviction) decide the fate of stragglers' later replays
            self.close_recovery()
        if self.recovering and req.opcode not in (
                "connect", "replay", "disconnect",
                "recovery_close") and not req.replay:
            # new requests are gated until the recovery window closes;
            # the reply tells the client how long is left so it backs
            # off sensibly instead of burning reconnect attempts
            return Reply(status=-11, data={
                "recovery_left": max(0.0, self.recovery_deadline
                                     - self.sim.now)})  # EAGAIN
        if req.replay:
            rej = self._vbr_admit(req, exp)
            if rej is not None:
                return rej
        fn = self.ops.get(req.opcode)
        if fn is None:
            return Reply(status=-38)       # ENOSYS
        keys = self.vbr_keys_for(req)
        pre = [(k, self.version_of(k)) for k in keys] if keys else None
        # the transno pin is scoped to THIS request: a replayed handler
        # may round-trip to a peer that synchronously calls back into us
        # (e.g. remote_nlink_adjust on a replayed create's parent), and
        # that nested txn must NOT consume the outer replay's number
        prev_pin = self._replay_tno
        self._replay_tno = req.transno if req.replay else 0
        try:
            reply = fn(req)
        except RpcError as e:
            reply = Reply(status=e.status)
        finally:
            self._replay_tno = prev_pin
        reply.last_committed = self.committed_transno
        if reply.transno:                   # update op: cache for resends
            if keys:
                for k in keys:
                    self.versions.setdefault(k, []).append(reply.transno)
                reply.pre_versions = pre
            sanitize.state.note_execute(self.uuid, req.client_uuid,
                                        req.xid, reply.transno)
            exp.volatile_replies[req.xid] = reply
            if reply.transno <= self.committed_transno:
                exp.reply_cache[req.xid] = reply
        exp.last_xid = max(exp.last_xid, req.xid)
        return reply

    # ------------------------------------------------- std ops: connect
    def op_connect(self, req: Request) -> Reply:
        exp = self.export_for(req.client_uuid, req.body.get("nid", ""))
        exp.conn_generation += 1
        exp.boot_count = req.boot_count
        self.evicted.discard(req.client_uuid)
        if self.recovering:
            self._recov_pending.discard(req.client_uuid)
            if not self._recov_pending \
                    or self.sim.now >= self.recovery_deadline:
                # every known client is back (or window expired): open
                # up. Stragglers are NOT evicted — VBR version checks
                # judge their replays if they ever return (§29.3 + VBR).
                self.close_recovery()
        return Reply(data={
            "boot_count": self.boot_count,
            "conn_generation": exp.conn_generation,
            "last_committed": self.committed_transno,
            "recovering": self.recovering,
        })

    def op_disconnect(self, req: Request) -> Reply:
        self.exports.pop(req.client_uuid, None)
        return Reply()

    def op_ping(self, req: Request) -> Reply:
        return Reply(data={"boot_count": self.boot_count})

    # ------------------------------------------------- std ops: monitor
    def mon_stats(self) -> dict:
        """Subclass hook: target-kind-specific sections of the monitoring
        snapshot (OST: grants/space, MDS: changelog/inodes, both: locks)."""
        return {}

    def op_mon_collect(self, req: Request) -> Reply:
        """One target's leaf of the cluster monitoring tree.  The reply
        payload is charged to the wire like any other (wire_size of the
        whole tree), so monitoring is a *cost-bearing* consumer the
        overhead gate can measure, not free introspection."""
        fail_mod.maybe_fail("mon.collect")
        data = {
            "uuid": self.uuid, "kind": self.svc_kind,
            "nid": self.node.nid, "boot_count": self.boot_count,
            "last_transno": self.transno,
            "last_committed": self.committed_transno,
            "recovering": self.recovering,
            "num_exports": len(self.exports),
            "nrs": self.service.policy.info(),
            "counters": dict(self.sim.stats.node_counters.get(self.uuid, {})),
            "latency": self.sim.metrics.target_summary(
                self.uuid, max_exports=req.body.get("max_exports", 32)),
        }
        data.update(self.mon_stats())
        return Reply(data=data)


# ------------------------------------------------------------------- node

class Node:
    """One machine: an NI + the targets and clients living on it."""

    def __init__(self, name: str, net: str, cluster: "ClusterBase"):
        self.name = name
        self.nid = f"{net}:{name}"
        self.cluster = cluster
        self.sim = cluster.sim
        self.ni = P.NI(self.nid, net, cluster.network)
        self.targets: dict[str, Target] = {}
        self.boot_count = 1
        cluster.nodes[self.name] = self
        self._post_request_buffers()

    def _post_request_buffers(self):
        """Pre-posted request buffers w/ receiver-managed offsets (§4.5.5).
        One MD per request portal; the EQ handler dispatches to targets."""
        for portal in set(REQUEST_PORTALS.values()) | {
                LDLM_CB_REQUEST_PORTAL}:
            eq = P.EventQueue(handler=self._request_in)
            md = P.MemoryDescriptor(length=1 << 30, threshold=-1,
                                    manage_remote_offset=True, eq=eq,
                                    user_ptr=portal)
            self.ni.me_attach(portal, 0, P.IGNORE_ALL, md)

    # --------------------------------------------------------- server in
    def _request_in(self, ev: P.Event):
        # service time starts at request arrival (the reply transmit below
        # then departs no earlier than this).
        self.sim.clock.advance_to(ev.arrival_time)
        req, reply_nid, reply_portal = ev.data
        target_uuid = req.body.get("_target", "")
        target = self.targets.get(target_uuid)
        if target is None:
            reply = Reply(status=-19)      # ENODEV
        else:
            fail = self.sim.fail
            fail.enter_service(target)
            # stats attribution context: every counter bumped while this
            # target serves the request lands in its per-node namespace
            # (nested server->server RPCs push the inner target on top)
            self.sim.stats.node_stack.append(target.uuid)
            try:
                fail.maybe_fail(f"ptlrpc.{target.svc_kind}.request_in")
                reply = target.service.process(req, ev.arrival_time)
                fail.maybe_fail(f"ptlrpc.{target.svc_kind}.before_reply")
                fail.raise_if_pending(target)
            except fail_mod.FailLocDrop:
                # OBD_FAIL_*_NET-style action: the in-flight request is
                # lost on the wire — target stays up, no reply goes out,
                # the client recovers via timeout -> resend
                self.sim.stats.count("fail.drop")
                return
            except fail_mod.FailLocHit:
                # the armed OBD_FAIL site powers the serving target off at
                # this exact point: uncommitted state dies through the
                # undo log, the in-flight request is dropped (no reply) —
                # the client recovers via timeout -> reconnect -> replay
                self.sim.stats.count("fail.crash")
                target.crash()
                target.restart()
                return
            finally:
                self.sim.stats.node_stack.pop()
                fail.exit_service(target)
                # request-boundary invariants: grant conservation +
                # (periodically) counter-partition, see core/sanitize.py
                sanitize.state.request_boundary(target)
        # reply PUT matched on xid (paper §4.5.2)
        nbytes = wire_size(reply) + reply.bulk_nbytes
        self.ni.put(reply_nid, reply_portal, req.xid, reply, nbytes)

    def register_target(self, t: Target):
        self.targets[t.uuid] = t

    # ----------------------------------------------------------- up/down
    def fail(self):
        """Power the node off: drop traffic + lose uncommitted state of
        the targets THIS node serves (standby registrations of targets
        primary-served elsewhere keep their journals — shared storage).
        A served target immediately "restarts" (possibly on its standby
        node): new boot count -> clients detect the reboot and replay."""
        self.sim.faults.down_nids.add(self.nid)
        for t in self.targets.values():
            if t.node is self:
                t.crash()
                t.restart()

    def restart(self):
        self.sim.faults.down_nids.discard(self.nid)
        self.boot_count += 1
        # the targets already restarted at fail() time, but the node was
        # unreachable then: re-run their announce hooks now so peers get
        # the imperative-recovery nudge (the pinger's job in real Lustre)
        for t in self.targets.values():
            if t.node is self:
                t.on_restart()


class ClusterBase:
    """Holds the simulator + network; subclassed by core.cluster."""

    def __init__(self, seed: int = 0):
        self.sim = Simulator(seed)
        self.network = P.PortalsNetwork(self.sim)
        self.nodes: dict[str, Node] = {}


# ----------------------------------------------------------------- import

class Import:
    """Client-side stub for one target (§4.6.8) with recovery.

    `nids` is the failover list (primary first). Requests flow through
    `self.request()`; on timeout the import disconnects, pings/reconnects
    (walking the failover ring), replays and resends, then retries.
    """

    def __init__(self, client: "RpcClient", target_uuid: str,
                 nids: list[str], svc_kind: str):
        self.client = client
        self.target_uuid = target_uuid
        self.nids = list(nids)
        self.active_nid = nids[0]
        self.svc_kind = svc_kind
        self.sim = client.sim
        self.state = "NEW"                 # NEW|FULL|DISCONN|REPLAY
        self.server_boot_count = 0
        self.last_committed = 0
        self.replay_list: list[Request] = []   # sent, uncommitted updates
        self.inflight: Request | None = None
        self.timeout = DEFAULT_TIMEOUT     # fixed fallback (AT disabled)
        self.max_reconnects = 8
        cl = getattr(client.node, "cluster", None)
        self.at = AdaptiveTimeout(
            at_min=getattr(cl, "at_min", AT_MIN),
            at_max=getattr(cl, "at_max", AT_MAX),
            enabled=getattr(cl, "adaptive_timeouts", True))
        self.backoff_base = BACKOFF_BASE
        self.backoff_max = BACKOFF_MAX
        self.generation = 0
        self.connect_data: dict = {}
        # eviction observers: upper layers (OSC page cache, LockClient,
        # dentry cache, MDS peer cross-check) register here — after a
        # -107 every piece of state the server granted this import is
        # void and MUST be dropped, not just the replay queue
        self.evict_cbs: list[Callable[[], None]] = []
        # `lctl --device deactivate` analogue: an administratively-inactive
        # import fails fast with -19 (ENODEV) instead of paying the full
        # reconnect walk on every touch — the LOV marks a dead OST inactive
        # so raid5 degraded paths and the rebuilder skip it cheaply
        self.deactivated = False

    # ------------------------------------------------------------ wiring
    @property
    def request_portal(self) -> int:
        return REQUEST_PORTALS[self.svc_kind]

    @property
    def reply_portal(self) -> int:
        return REPLY_PORTALS[self.svc_kind]

    # --------------------------------------------------------------- rpc
    def rpc_timeout(self, opcode: str) -> float:
        """Per-op timeout: the AT estimate when adaptive, else fixed."""
        if self.at.enabled:
            return self.at.timeout_for(opcode)
        return self.timeout

    def _backoff(self, attempt: int):
        """Capped exponential backoff with deterministic jitter between
        reconnect attempts — N clients losing the same server no longer
        hammer it in lockstep, and the schedule is reproducible."""
        base = min(self.backoff_max, self.backoff_base * (2 ** attempt))
        h = zlib.crc32(f"{self.client.uuid}:{self.target_uuid}:"
                       f"{attempt}".encode())
        # jitter in [0.5, 1.0) * base, derived from stable identifiers
        self.sim.clock.advance(base * (0.5 + (h % 1024) / 2048.0))
        self.sim.stats.count("rpc.reconnect_backoff")

    def _send_once(self, req: Request,
                   timeout: float | None = None) -> Reply | None:
        """One wire attempt. None = timeout/drop.

        AT semantics (ch. 11): the request carries an absolute deadline;
        a reply that lands after it is a SPURIOUS TIMEOUT — dropped here
        exactly as if the wire ate it (the resend is answered from the
        reply cache) — unless the server granted an early reply
        extending the deadline past the arrival."""
        if timeout is None:
            timeout = self.rpc_timeout(req.opcode)
        t0 = self.sim.now
        req.sent_at = t0
        req.deadline = t0 + timeout
        eq = P.EventQueue()
        md = P.MemoryDescriptor(length=1 << 22, threshold=1, eq=eq)
        self.client.ni.me_attach(self.reply_portal, req.xid, 0, md)
        nbytes = wire_size(req) + req.bulk_nbytes
        t_arr = self.client.ni.put(self.active_nid, self.request_portal,
                                   req.xid, (req, self.client.nid,
                                             self.reply_portal), nbytes)
        if t_arr == float("inf") or not md.buffer:
            # request or reply lost: wait out the timeout (§4.4.2.3)
            self.sim.clock.advance(timeout)
            md.unlinked = True             # unlink ME/MD after timeout
            self.sim.stats.count("rpc.timeout")
            return None
        ev = eq.pop()
        _, reply = md.buffer[0]
        arrival = ev.arrival_time
        if arrival > req.deadline + 1e-12 \
                and reply.early_until + 1e-12 < arrival:
            # the reply exists but the client already gave up at the
            # deadline and no early reply extended it: a spurious
            # timeout — the loaded-server failure mode AT exists to kill
            md.unlinked = True
            self.sim.clock.advance_to(max(self.sim.now, req.deadline))
            self.sim.stats.count("rpc.timeout")
            self.sim.stats.count("rpc.timeout_spurious")
            return None
        if arrival > req.deadline + 1e-12:
            self.sim.stats.count("rpc.early_reply_rescue")
        self.sim.clock.advance_to(arrival)
        if self.at.enabled:
            self.at.observe(req.opcode, arrival - t0)
        return reply

    def request(self, opcode: str, body: dict, *, bulk_nbytes: int = 0,
                no_recover: bool = False, fixup=None) -> Reply:
        """Send a request with full recovery semantics; raises RpcError on
        application errors, TimeoutError_ if the target stays unreachable."""
        if self.deactivated:
            raise RpcError(-19, f"{self.target_uuid} deactivated")
        if self.state in ("NEW", "DISCONN"):
            self._connect_cycle()
        req = Request(opcode=opcode, body=dict(body, _target=self.target_uuid),
                      xid=self.client.next_xid(), client_uuid=self.client.uuid,
                      boot_count=self.client.boot_count,
                      conn_generation=self.generation,
                      bulk_nbytes=bulk_nbytes, jobid=self.client.jobid,
                      trace_id=next(_trace_seq))
        attempt = 0
        eagain_waited = 0.0
        while attempt < self.max_reconnects:
            reply = self._send_once(req)
            if reply is None:
                if no_recover:
                    raise TimeoutError_(f"{self.target_uuid} unreachable")
                attempt += 1
                self.state = "DISCONN"
                self._backoff(attempt - 1)
                self._connect_cycle()      # may replay + walk failover ring
                continue
            if reply.status == -11:        # EAGAIN: server in recovery
                # wait out what the server says is left of its window
                # (client-count-scaled windows outlive any fixed retry
                # budget); a separate time budget bounds the spin
                left = 0.5
                if isinstance(reply.data, dict):
                    left = max(0.05, min(0.5,
                                         reply.data.get(
                                             "recovery_left", 0.5)))
                eagain_waited += left
                if eagain_waited > 4 * 60.0:
                    raise TimeoutError_(
                        f"{self.target_uuid} stuck in recovery")
                self.sim.clock.advance(left)
                continue
            if reply.status == -108:       # stale connection: server reboot
                attempt += 1
                self.state = "DISCONN"
                self._connect_cycle()
                req.body["_target"] = self.target_uuid
                req.conn_generation = self.generation
                continue
            if reply.status == -107:       # evicted: state is gone — drop
                # replay queue, reconnect fresh, retry (client-visible data
                # loss is the eviction's documented cost)
                attempt += 1
                self.sim.stats.count("rpc.evicted_reconnect")
                self.replay_list.clear()
                self.state = "DISCONN"
                self.server_boot_count = 0
                self._connect_cycle()
                req.conn_generation = self.generation
                # server-granted state died with the export: locks, dirty
                # extents, clean pages, dentries — observers drop it all
                # (and the MDS peer cross-check repairs namespace halves)
                for cb in list(self.evict_cbs):
                    cb()
                continue
            self._note_reply(req, reply)
            if reply.status:
                raise RpcError(reply.status, opcode)
            if fixup is not None:
                # let the caller pin server-assigned ids (oid/fid) into the
                # retained request so REPLAY recreates identical objects
                # (the paper's create-with-requested-id, §5.2.3)
                fixup(req, reply)
            return reply
        raise TimeoutError_(f"{self.target_uuid} unreachable")

    def _note_reply(self, req: Request, reply: Reply):
        self.last_committed = max(self.last_committed, reply.last_committed)
        if reply.transno:
            req.transno = reply.transno
            if reply.pre_versions is not None:
                # VBR: retain the observed pre-op versions with the
                # request — a later replay ships them as its proof that
                # re-execution still applies to the same state
                req.body["_vbr"] = reply.pre_versions
            self.replay_list.append(req)
        # prune replay list: server committed these (§29: last_committed)
        self.replay_list = [r for r in self.replay_list
                            if r.transno > self.last_committed]

    # ---------------------------------------------------------- recovery
    def _connect_cycle(self, max_attempts: int | None = None):
        """Reconnect, walking the failover nid ring with capped
        exponential backoff between attempts (no more N flat timeout
        spins in lockstep); on a server reboot, replay
        committed-but-lost transactions then mark FULL."""
        last_err = None
        n = self.max_reconnects if max_attempts is None else max_attempts
        for attempt in range(n):
            if attempt:
                self._backoff(attempt - 1)
            nid = self.nids[attempt % len(self.nids)]
            self.active_nid = nid
            creq = Request(opcode="connect",
                           body={"_target": self.target_uuid,
                                 "nid": self.client.nid},
                           xid=self.client.next_xid(),
                           client_uuid=self.client.uuid,
                           boot_count=self.client.boot_count)
            reply = self._send_once(creq)
            if reply is None or reply.status:
                last_err = reply
                continue
            self.generation = reply.data["conn_generation"]
            self.connect_data = dict(reply.data)
            new_boot = reply.data["boot_count"]
            rebooted = (self.server_boot_count
                        and new_boot != self.server_boot_count)
            self.server_boot_count = new_boot
            if rebooted:
                self.sim.stats.count("rpc.server_reboot_detected")
                self._replay(reply.data["last_committed"])
            self.state = "FULL"
            return
        self.state = "DISCONN"
        raise TimeoutError_(
            f"connect {self.target_uuid} failed: {last_err}")

    def _replay(self, server_last_committed: int):
        """Replay transactions the server lost, oldest first (§29.2)."""
        self.state = "REPLAY"
        todo = sorted((r for r in self.replay_list
                       if r.transno > server_last_committed),
                      key=lambda r: r.transno)
        self.replay_list = []
        evicted = False
        for req in todo:
            req.replay = True
            req.conn_generation = self.generation
            self.sim.stats.count("rpc.replay")
            reply = self._send_once(req)
            if reply is None:
                # server vanished mid-replay: keep for the next cycle
                self.replay_list.append(req)
            elif reply.status == -107:
                # VBR conflict: a straggler's gap invalidated this
                # replay — the whole import's server-side state is gone,
                # stop replaying and let the next request's -107 path
                # run the full eviction cleanup (evict_cbs etc.)
                self.sim.stats.count("rpc.replay_vbr_rejected")
                self.replay_list.clear()
                evicted = True
                break
            elif reply.transno:
                req.transno = reply.transno
                self.replay_list.append(req)
        self.state = "FULL"
        return not evicted

    def ping(self) -> bool:
        """Health probe (§4.4.2.5).  Works even on a deactivated import —
        the pinger is precisely how a dead target's RETURN gets noticed —
        and never walks the full reconnect ladder (one probe per tick).
        A reply carrying a new server boot count triggers IMPERATIVE
        RECOVERY: reconnect + replay right now, instead of discovering
        the reboot via the next request's timeout."""
        if self.state != "FULL":
            if fail_mod.state.check("ping.notify") in ("drop", "crash"):
                return False       # notification lost: stay down a tick
            prev_boot = self.server_boot_count
            try:
                self._connect_cycle(max_attempts=1)
            except TimeoutError_:
                return False
            if prev_boot and self.server_boot_count != prev_boot:
                # the pinger (not a timed-out request) found the reboot
                self.sim.stats.count("rpc.imperative_recovery")
            return True
        req = Request(opcode="ping",
                      body={"_target": self.target_uuid},
                      xid=self.client.next_xid(),
                      client_uuid=self.client.uuid,
                      boot_count=self.client.boot_count,
                      conn_generation=self.generation)
        reply = self._send_once(req)
        if reply is None or reply.status:
            self.state = "DISCONN"
            return False
        boot = (reply.data or {}).get("boot_count", 0)
        if boot and self.server_boot_count \
                and boot != self.server_boot_count:
            act = fail_mod.state.check("ping.notify")
            if act in ("drop", "crash"):
                # notification lost: the client falls back to the
                # timeout-driven path on its next real request
                return True
            self.sim.stats.count("rpc.imperative_recovery")
            self.state = "DISCONN"
            try:
                self._connect_cycle()
            except TimeoutError_:
                return False
        return True


class RpcClient:
    """Client networking context: uuid + NI + xid sequence (§4.6.7)."""

    _uuid_seq = itertools.count()

    def __init__(self, node: Node):
        self.node = node
        self.ni = node.ni
        self.nid = node.nid
        self.network = node.cluster.network
        self.sim = node.sim
        self.uuid = f"client-{node.name}-{next(self._uuid_seq)}"
        self.jobid = ""              # stamped into every Request (the
                                     # JOBENV tag of real Lustre clients)
        self.boot_count = 1
        self._xid = itertools.count(1)
        self.imports: dict[str, Import] = {}

    def next_xid(self) -> int:
        # unique per client; never reused, even across recovery (§4.4.2.3)
        return next(self._xid)

    def import_target(self, target_uuid: str, nids: list[str],
                      svc_kind: str) -> Import:
        imp = Import(self, target_uuid, nids, svc_kind)
        self.imports[target_uuid] = imp
        return imp
