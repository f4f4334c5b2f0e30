"""Distributed Lock Manager (paper ch. 7 and 27).

Faithful pieces:
  * six lock modes EX PW PR CW CR NL (+ Lustre's group locks, ch. 10.10)
    with the VMS compatibility matrix;
  * resources keyed by (type, id) holding granted/waiting queues;
  * *extent* policy: the server grants the **largest possible extent** that
    does not conflict with other granted/waiting locks (§7.5);
  * *intent* policy: the enqueue carries an operation; the server executes
    it while granting (one RPC for lookup+lock+op) (§7.5, §6.2.2);
  * blocking + completion ASTs as real (reverse) RPCs to lock holders;
    holders flush/cancel; unresponsive holders are **evicted** (§7.4);
  * lock value blocks carrying size/mtime/version (§7.7);
  * client-side lock cache with `match` (no RPC when a compatible cached
    lock covers the extent).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import defaultdict
from typing import Any, Callable, Optional

from repro_torch.core import fail as fail_mod
from repro_torch.core import ptlrpc as R
from repro_torch.core import sanitize

MAX_EXT = (1 << 64) - 1
WHOLE = (0, MAX_EXT)

MODES = ("EX", "PW", "PR", "CW", "CR", "NL", "GR")

# row = held, col = requested : True = compatible (VMS matrix, §7.3)
_C = {
    "NL": {"NL": 1, "CR": 1, "CW": 1, "PR": 1, "PW": 1, "EX": 1, "GR": 1},
    "CR": {"NL": 1, "CR": 1, "CW": 1, "PR": 1, "PW": 1, "EX": 0, "GR": 0},
    "CW": {"NL": 1, "CR": 1, "CW": 1, "PR": 0, "PW": 0, "EX": 0, "GR": 0},
    "PR": {"NL": 1, "CR": 1, "CW": 0, "PR": 1, "PW": 0, "EX": 0, "GR": 0},
    "PW": {"NL": 1, "CR": 1, "CW": 0, "PR": 0, "PW": 0, "EX": 0, "GR": 0},
    "EX": {"NL": 1, "CR": 0, "CW": 0, "PR": 0, "PW": 0, "EX": 0, "GR": 0},
    "GR": {"NL": 1, "CR": 0, "CW": 0, "PR": 0, "PW": 0, "EX": 0, "GR": 1},
}


def compatible(held: "Lock", req_mode: str, req_gid: int = 0) -> bool:
    ok = bool(_C[held.mode][req_mode])
    if held.mode == "GR" and req_mode == "GR":
        return held.gid == req_gid          # group locks share a gid
    return ok


def mode_covers(held: str, req: str) -> bool:
    """A cached lock of mode `held` satisfies a request for mode `req`
    iff `held` is at least as strong: everything incompatible with `req`
    must also be incompatible with `held` (so holding it grants at least
    the protection the requester asked for). Derived straight from the
    VMS matrix — a cached CR lock does NOT satisfy a PR request."""
    return all(_C[held][x] <= _C[req][x] for x in MODES)


def overlaps(a: tuple | None, b: tuple | None) -> bool:
    if a is None or b is None:
        return True                          # plain locks conflict wholly
    return a[0] < b[1] and b[0] < a[1]


_handle_seq = itertools.count(1)


@dataclasses.dataclass
class Lock:
    handle: int
    res_name: tuple
    mode: str
    extent: tuple | None                    # (start, end) end-exclusive
    client_uuid: str
    client_nid: str
    gid: int = 0
    granted: bool = False
    lvb: dict = dataclasses.field(default_factory=dict)
    # client-side:
    refcount: int = 0
    dirty: bool = False                     # pages under this lock to flush

    def covers(self, mode: str, extent: tuple | None) -> bool:
        if not mode_covers(self.mode, mode):
            return False
        if extent is None or self.extent is None:
            return True
        return self.extent[0] <= extent[0] and extent[1] <= self.extent[1]


class Resource:
    def __init__(self, name: tuple):
        self.name = name
        self.granted: list[Lock] = []
        self.waiting: list[Lock] = []
        self.lvb: dict = {}                  # size/mtime/version block
        self.version = 0

    def conflicting(self, mode: str, extent: tuple | None, gid: int,
                    exclude_client: str | None = None) -> list[Lock]:
        out = []
        for lk in self.granted:
            if exclude_client and lk.client_uuid == exclude_client:
                continue
            if not compatible(lk, mode, gid) and overlaps(lk.extent, extent):
                out.append(lk)
        return out


class LdlmNamespace:
    """Server-side lock namespace, embedded in an OST/MDS target.

    The owning target registers our ops on itself and provides an RpcClient
    for reverse (AST) RPCs.
    """

    def __init__(self, target: R.Target, rpc_client: R.RpcClient,
                 intent_policy: Callable | None = None,
                 lvb_update: Callable | None = None):
        self.target = target
        self.sim = target.sim
        self.rpc = rpc_client
        self.resources: dict[tuple, Resource] = {}
        self.intent_policy = intent_policy
        self.lvb_update = lvb_update        # res -> fills res.lvb
        self.conflict_cb = None             # res_name -> None (contention)
        self._cb_imports: dict[str, R.Import] = {}
        t = target
        t.ops["ldlm_enqueue"] = self.op_enqueue
        t.ops["ldlm_cancel"] = self.op_cancel
        t.ops["ldlm_locks_for"] = self.op_locks_for

    # ------------------------------------------------------------- state
    def resource(self, name) -> Resource:
        name = tuple(name)
        res = self.resources.get(name)
        if res is None:
            res = self.resources[name] = Resource(name)
        return res

    def holders(self, name, mode: str = "PR") -> list[Lock]:
        """Clients holding >= mode locks (used by the COBD referral)."""
        res = self.resources.get(tuple(name))
        if not res:
            return []
        return [lk for lk in res.granted if lk.covers(mode, None) or
                lk.mode == mode]

    # -------------------------------------------------------------- RPC
    def _cb_import(self, client_uuid: str, client_nid: str) -> R.Import:
        imp = self._cb_imports.get(client_uuid)
        if imp is None:
            imp = self.rpc.import_target(f"lcb:{client_uuid}",
                                         [client_nid], "ldlm_cb")
            self._cb_imports[client_uuid] = imp
        return imp

    def _glimpse_ast(self, lk: Lock) -> dict | None:
        """Ask the holder for its CURRENT lock value block without
        revoking the lock (§7.7 glimpse): the writer keeps its PW lock
        and its write-back cache, the server learns the live size/mtime.
        Returns None when the holder is unreachable or knows nothing —
        the caller falls back to the on-disk attributes."""
        self.sim.stats.count("dlm.glimpse_ast")
        imp = self._cb_import(lk.client_uuid, lk.client_nid)
        try:
            rep = imp.request("glimpse_ast",
                              {"handle": lk.handle,
                               "res": list(lk.res_name)},
                              no_recover=True)
            d = rep.data or {}
            return None if d.get("unknown") else d
        except (R.TimeoutError_, R.RpcError):
            self.sim.stats.count("dlm.glimpse_timeout")
            return None

    def glimpse_lvb(self, name, base: dict | None = None) -> dict:
        """Current LVB for a resource: on-disk state merged with what
        PW/EX/GR holders report over glimpse ASTs. This is how a stat of
        a file under write learns the live size WITHOUT killing the
        writer's cache (before: a PR enqueue revoked the PW lock).
        `base` lets a caller that already read the disk attributes seed
        the LVB instead of paying a second backend read."""
        res = self.resource(tuple(name))
        if base is not None:
            lvb = dict(base)
        else:
            if self.lvb_update:
                self.lvb_update(res)
            lvb = dict(res.lvb)
        for lk in list(res.granted):
            if lk.mode in ("PW", "EX", "GR"):
                d = self._glimpse_ast(lk)
                if d and "size" in d:
                    lvb["size"] = max(lvb.get("size", 0), d["size"])
                    lvb["mtime"] = max(lvb.get("mtime", 0.0),
                                       d.get("mtime", 0.0))
        return lvb

    def _blocking_ast(self, lk: Lock) -> bool:
        """Ask the holder to drop `lk`. Returns False if the holder is
        unreachable (-> eviction)."""
        self.sim.stats.count("dlm.blocking_ast")
        act = fail_mod.state.check("dlm.blocking_ast")
        if act == "drop":
            # the AST is lost on the wire: the holder never answers and
            # is treated exactly like a dead client (§7.4 -> eviction)
            return False
        if act == "crash":
            # mid-revocation server crash, deferred to the request
            # boundary of the target serving the triggering enqueue
            fail_mod.state.defer("dlm.blocking_ast")
        imp = self._cb_import(lk.client_uuid, lk.client_nid)
        try:
            rep = imp.request("blocking_ast",
                              {"handle": lk.handle,
                               "res": list(lk.res_name)},
                              no_recover=True)
            if (rep.data or {}).get("unknown"):
                # holder lost the lock state: reap it server-side
                res = self.resources.get(lk.res_name)
                if res and lk in res.granted:
                    res.granted.remove(lk)
                self.sim.stats.count("dlm.stale_lock_reaped")
            return True
        except (R.TimeoutError_, R.RpcError):
            return False

    def evict_client(self, client_uuid: str):
        """Drop every lock of a dead client (§7.4 AST timeout -> evict)."""
        self.sim.stats.count("dlm.evictions")
        self.target.evicted.add(client_uuid)
        for res in self.resources.values():
            res.granted = [l for l in res.granted
                           if l.client_uuid != client_uuid]
            res.waiting = [l for l in res.waiting
                           if l.client_uuid != client_uuid]

    # ------------------------------------------------- extent grant policy
    def _grow_extent(self, res: Resource, lk: Lock) -> tuple | None:
        """§7.5: grant the *largest* extent containing the request that does
        not overlap any extent of a conflicting granted/waiting lock."""
        if lk.extent is None:
            return None
        lo, hi = 0, MAX_EXT
        for other in res.granted + res.waiting:
            if other is lk or other.client_uuid == lk.client_uuid:
                continue
            if compatible(other, lk.mode, lk.gid):
                continue
            if other.extent is None:
                return lk.extent              # plain conflict: no growth
            os_, oe = other.extent
            if oe <= lk.extent[0]:
                lo = max(lo, oe)
            elif os_ >= lk.extent[1]:
                hi = min(hi, os_)
        return (lo, hi)

    # ----------------------------------------------------------- enqueue
    def op_enqueue(self, req: R.Request) -> R.Reply:
        b = req.body
        name = tuple(b["res"])
        mode = b["mode"]
        extent = tuple(b["extent"]) if b.get("extent") else None
        gid = b.get("gid", 0)
        res = self.resource(name)

        # conflict resolution FIRST: Lustre strictly orders "locks are
        # acquired before the associated data is used" (§6.2.3) — the
        # intent below must see post-revocation state (WBC holders flush
        # on the blocking AST before the lookup runs).
        lk = Lock(next(_handle_seq), name, mode, extent,
                  req.client_uuid, b.get("client_nid", ""), gid=gid)
        res.waiting.append(lk)
        conf = res.conflicting(mode, extent, gid,
                               exclude_client=req.client_uuid)
        # lockdep: a CONFLICTING enqueue orders everything the requester
        # already holds before this resource (glimpse enqueues never
        # wait — they are answered with the merged LVB below)
        sanitize.state.note_enqueue(
            req.client_uuid, (self.target.uuid, name),
            bool(conf) and not b.get("glimpse"))
        if b.get("glimpse") and conf:
            # glimpse enqueue (§7.7): the requester only wants the LVB —
            # do NOT revoke the conflicting holders; ask them for their
            # value blocks instead and answer without granting
            res.waiting.remove(lk)
            self.sim.stats.count("dlm.glimpse_served")
            return R.Reply(data={"handle": 0, "granted": False,
                                 "intent": None,
                                 # lint: rpc-under-lock(glimpse ASTs never
                                 # revoke and holders answer from their own
                                 # ldlm_cb service, so no wait cycle forms)
                                 "lvb": self.glimpse_lvb(name),
                                 "version": res.version})
        if conf and self.conflict_cb:
            self.conflict_cb(name)
        for other in list(conf):
            # lint: rpc-under-lock(revocation protocol: the blocking AST
            # goes to a DIFFERENT client's ldlm_cb service and the holder
            # yields rather than acquires, so this wait cannot cycle)
            ok = self._blocking_ast(other)
            if not ok:
                self.evict_client(other.client_uuid)
        # after ASTs, holders have cancelled (synchronously); re-check
        conf = res.conflicting(mode, extent, gid,
                               exclude_client=req.client_uuid)
        if conf:
            # still conflicting (another same-arrival waiter) — in the
            # synchronous model this cannot block forever; deny politely.
            res.waiting.remove(lk)
            return R.Reply(status=-11)

        intent_data = None
        if b.get("intent") and self.intent_policy:
            # intent policy: execute the op server-side while granting
            # (it may veto the lock entirely, e.g. highly-contended res).
            intent_data, grant = self.intent_policy(req, res)
            if not grant:
                res.waiting.remove(lk)
                rep = R.Reply(data={"handle": 0, "granted": False,
                                    "intent": intent_data,
                                    "lvb": dict(res.lvb)})
                if isinstance(intent_data, dict) and \
                        intent_data.get("_transno"):
                    rep.transno = intent_data["_transno"]
                return rep

        lk.extent = self._grow_extent(res, lk)
        res.waiting.remove(lk)
        lk.granted = True
        res.granted.append(lk)
        if self.lvb_update:
            self.lvb_update(res)
        self.sim.stats.count("dlm.granted")
        rep = R.Reply(data={"handle": lk.handle, "granted": True,
                            "mode": mode, "extent": lk.extent,
                            "intent": intent_data, "lvb": dict(res.lvb),
                            "version": res.version})
        if isinstance(intent_data, dict) and intent_data.get("_transno"):
            rep.transno = intent_data["_transno"]   # replayable intent op
        return rep

    def op_cancel(self, req: R.Request) -> R.Reply:
        h = req.body["handle"]
        for res in self.resources.values():
            for lk in res.granted:
                if lk.handle == h:
                    res.granted.remove(lk)
                    self.sim.stats.count("dlm.cancel")
                    return R.Reply()
        return R.Reply()                     # cancel of unknown lock: ok

    def op_locks_for(self, req: R.Request) -> R.Reply:
        """Referral support: who holds `mode` locks overlapping extent?"""
        res = self.resources.get(tuple(req.body["res"]))
        mode = req.body.get("mode", "PR")
        extent = tuple(req.body["extent"]) if req.body.get("extent") else None
        out = []
        if res:
            for lk in res.granted:
                if lk.mode == mode and overlaps(lk.extent, extent):
                    out.append({"client_uuid": lk.client_uuid,
                                "client_nid": lk.client_nid,
                                "extent": lk.extent})
        return R.Reply(data=out)

    def bump_version(self, name, **lvb):
        res = self.resource(name)
        res.version += 1
        res.lvb.update(lvb)


# ---------------------------------------------------------------- client

class LockCallbackTarget(R.Target):
    """Per-RpcClient pseudo-target receiving ASTs (reverse RPCs). One
    client uuid holds locks in MANY namespaces (each OST + each MDS), so
    this dispatcher routes by lock handle to the owning LockClient."""

    svc_kind = "ldlm_cb"

    def __init__(self, rpc_uuid: str, node: R.Node):
        super().__init__(f"lcb:{rpc_uuid}", node)
        self.clients: list["LockClient"] = []
        self.ops["blocking_ast"] = self.op_blocking_ast
        self.ops["glimpse_ast"] = self.op_glimpse_ast

    def op_glimpse_ast(self, req: R.Request) -> R.Reply:
        h = req.body["handle"]
        for lc in self.clients:
            if h in lc.locks:
                return R.Reply(data=lc.on_glimpse_ast(h))
        return R.Reply(data={"unknown": True})

    def op_blocking_ast(self, req: R.Request) -> R.Reply:
        h = req.body["handle"]
        for lc in self.clients:
            if h in lc.locks:
                lc.on_blocking_ast(h, tuple(req.body["res"]))
                return R.Reply()
        # no LockClient knows this handle: the lock state was lost on this
        # client — tell the server to reap it (implicit cancel)
        return R.Reply(data={"unknown": True})


class LockClient:
    """Client lock cache for one remote namespace (one OST or MDS).

    `flush_cb(lock)` is provided by the data layer (page-cache writeback
    before a PW lock is surrendered). `revoke_cbs` fire whenever a lock
    leaves the cache for ANY reason (blocking AST, cancel, eviction) —
    clean cached pages are valid exactly while a lock covers them
    (§7.4/§7.6), so the data layer invalidates them here."""

    def __init__(self, rpc: R.RpcClient, server_import: R.Import,
                 flush_cb: Callable[["Lock"], None] | None = None):
        self.rpc = rpc
        self.imp = server_import
        self.sim = rpc.sim
        self.flush_cb = flush_cb
        # glimpse_cb(lock) -> {"size","mtime"}: the data layer reports its
        # CURRENT value block (dirty cache included) without dropping the
        # lock when the server glimpses it (§7.7)
        self.glimpse_cb: Callable[["Lock"], dict] | None = None
        self.revoke_cbs: list[Callable[["Lock"], None]] = []
        self.locks: dict[int, Lock] = {}
        self.by_res: defaultdict = defaultdict(list)
        node = rpc.node
        key = f"lcb:{rpc.uuid}"
        cbt = node.targets.get(key)
        if cbt is None:
            cbt = LockCallbackTarget(rpc.uuid, node)
        cbt.clients.append(self)

    # -------------------------------------------------------------- match
    def match(self, res_name, mode: str, extent=None) -> Lock | None:
        for lk in self.by_res.get(tuple(res_name), ()):
            if lk.covers(mode, extent):
                self.sim.stats.count("dlm.client_match")
                return lk
        return None

    # ------------------------------------------------------------ enqueue
    def enqueue(self, res_name, mode: str, extent=None, *, gid: int = 0,
                intent: dict | None = None, use_cache: bool = True,
                glimpse: bool = False, fixup=None):
        """Returns (lock | None, intent_data, lvb). With `glimpse` the
        server answers a conflicting enqueue with the holders' merged
        LVB instead of revoking them (lock comes back None)."""
        if use_cache and not intent:
            lk = self.match(res_name, mode, extent)
            if lk is not None:
                return lk, None, dict(lk.lvb)
        body = {"res": list(res_name), "mode": mode,
                "extent": list(extent) if extent else None,
                "gid": gid, "client_nid": self.rpc.nid, "intent": intent,
                "glimpse": glimpse}
        rep = self.imp.request("ldlm_enqueue", body, fixup=fixup)
        d = rep.data
        if not d["granted"]:
            return None, d.get("intent"), d.get("lvb", {})
        lk = Lock(d["handle"], tuple(res_name), mode,
                  tuple(d["extent"]) if d.get("extent") else None,
                  self.rpc.uuid, self.rpc.nid, gid=gid, granted=True,
                  lvb=d.get("lvb", {}))
        self.locks[lk.handle] = lk
        self.by_res[lk.res_name].append(lk)
        sanitize.state.note_granted(self.rpc.uuid,
                                    (self.imp.target_uuid, lk.res_name))
        return lk, d.get("intent"), d.get("lvb", {})

    def _forget(self, lk: Lock):
        """Drop a lock from the cache + notify the data layer: pages the
        lock covered are no longer protected."""
        self.locks.pop(lk.handle, None)
        if lk in self.by_res.get(lk.res_name, ()):
            self.by_res[lk.res_name].remove(lk)
        sanitize.state.note_released(self.rpc.uuid,
                                     (self.imp.target_uuid, lk.res_name))
        for cb in self.revoke_cbs:
            cb(lk)

    def cancel(self, lk: Lock):
        if self.flush_cb and lk.dirty:
            self.flush_cb(lk)
            lk.dirty = False
        self._forget(lk)
        try:
            self.imp.request("ldlm_cancel", {"handle": lk.handle})
        except (R.TimeoutError_, R.RpcError):
            pass

    def cancel_all(self):
        for lk in list(self.locks.values()):
            self.cancel(lk)

    def drop_all(self):
        """Local-only teardown (server evicted us: it already dropped our
        locks, so no cancel RPCs): every covered page is invalidated."""
        for lk in list(self.locks.values()):
            lk.dirty = False
            self._forget(lk)
        self.by_res.clear()

    # --------------------------------------------------------------- ASTs
    def on_glimpse_ast(self, handle: int) -> dict:
        """Server asks for our current LVB: answer WITHOUT flushing or
        dropping anything — that is the whole point of the glimpse."""
        lk = self.locks.get(handle)
        self.sim.stats.count("dlm.client_glimpse_ast")
        if lk is None:
            return {"unknown": True}
        if self.glimpse_cb is not None:
            return self.glimpse_cb(lk) or {}
        return dict(lk.lvb)

    def on_blocking_ast(self, handle: int, res_name: tuple):
        lk = self.locks.get(handle)
        self.sim.stats.count("dlm.client_bl_ast")
        if lk is None:
            return
        if self.flush_cb and lk.dirty:
            self.flush_cb(lk)
            lk.dirty = False
        # revocation drops CLEAN pages too (revoke_cbs inside _forget):
        # the writer about to be granted will change data under this
        # lock, so serving the old pages later would be stale (§7.4)
        self._forget(lk)
        # lock cancel goes back to the server as its own RPC
        try:
            self.imp.request("ldlm_cancel", {"handle": handle})
        except (R.TimeoutError_, R.RpcError):
            pass
