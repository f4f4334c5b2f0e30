"""Lustre Metadata Service (paper ch. 6, 26).

Namespace model (§6.2): inodes keyed by *fid* = (inode_group, ino, gen) —
fids are never reused and uniquely identify an inode. Elements are
(parent_fid, name, fid) triples. File inodes hold NO data, only the LOV
stripe descriptor in an extended attribute (§2.2, §10.2).

Implemented:
  * intent handling (§6.2.2/§7.5): lookup/getattr/open/create execute inside
    the DLM enqueue — one RPC;
  * reintegration ops mds_reint_{create,unlink,rename,link,setattr} (§6.4.2)
    with transactional undo records;
  * unlink returns the LOV EA + llog cookies so the *client* destroys the
    data objects; OSTs confirm with llog_cancel once their destroy commits
    (ch. 8.4); pending records re-shipped after MDS recovery (§6.7.5);
  * clustered MDS (§6.7): each MDS owns an inode group; mkdir round-robins
    new directories onto other MDSes; large directories *split* into hash
    buckets on peer MDSes (master inode EA lists bucket fids); cross-MDS
    rename/link/unlink via MDS-MDS RPCs with *dependency tracking* feeding
    the consistent-cut snapshot (§6.7.6.3, implemented in recovery.py);
  * metadata write-back-cache grants: a client may be granted a subtree
    lock + a preallocated fid range and reintegrate batched update records
    later (ch. 17, §6.5);
  * open files tracked per-export so failed clients' orphans get cleaned;
  * per-MDT changelog (core.changelog): every reint/close/remote op emits
    a typed record inside its transaction undo scope; consumers register/
    read/clear over ptlrpc (changelog_* ops) with min-bookmark purging.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
from typing import Any, Optional

from repro_torch.core import changelog as cl_mod
from repro_torch.core import dlm as dlm_mod
from repro_torch.core import fail as fail_mod
from repro_torch.core import llog as llog_mod
from repro_torch.core import ptlrpc as R
from repro_torch.core import recovery as rec_mod

ROOT_FID = (0, 1, 1)

S_IFDIR, S_IFREG, S_IFLNK = "dir", "file", "symlink"


@dataclasses.dataclass
class Inode:
    fid: tuple
    ftype: str
    mode: int = 0o644
    uid: int = 0
    gid: int = 0
    nlink: int = 1
    mtime: float = 0.0
    size: int = 0
    ea: dict = dataclasses.field(default_factory=dict)
    entries: dict = dataclasses.field(default_factory=dict)  # dirs
    symlink: str = ""
    # mtime/size delegated to OSTs while a writer has the file open (§6.9.1)
    mtime_on_ost: bool = False
    # LOCAL directory fids this inode is (or was) linked under: the dir
    # PR locks covering clients' cached copies of our attributes (dentry
    # + attr cache). setattr/close revoke these. Add-only — a stale
    # entry costs a spurious revocation, never a stale cache.
    pfids: set = dataclasses.field(default_factory=set)
    # (peer_uuid, dir_fid) pairs for directories a PEER MDT owns that
    # link this inode (cross-MDT mkdir/create halves): an attr change
    # here forwards a revoke_dir_locks to the peer so clients scanning
    # THAT directory drop their (one-shot) copies of our attrs too.
    remote_pfids: set = dataclasses.field(default_factory=set)

    def attrs(self) -> dict:
        return {"fid": self.fid, "type": self.ftype, "mode": self.mode,
                "uid": self.uid, "gid": self.gid, "nlink": self.nlink,
                "mtime": self.mtime, "size": self.size,
                "mtime_on_ost": self.mtime_on_ost,
                "nentries": len(self.entries) if self.ftype == S_IFDIR
                else None,
                "has_buckets": "buckets" in self.ea}


def _cl_create_type(ftype: str) -> str:
    return {S_IFDIR: cl_mod.CL_MKDIR,
            S_IFLNK: cl_mod.CL_SYMLINK}.get(ftype, cl_mod.CL_CREAT)


def _pin_remote_fid(req, rep):
    """MDS-MDS create fixup: pin the peer-assigned fid into the retained
    request so REPLAY after a peer crash recreates the SAME inode (the
    create-with-requested-id rule, §5.2.3 — without it a replayed
    remote_mkdir mints a fresh fid the coordinator's entry never finds)."""
    if (rep.data or {}).get("fid"):
        req.body["fid"] = tuple(rep.data["fid"])


def fhash(name: str, n: int) -> int:
    """Stable directory-bucket hash."""
    h = 2166136261
    for ch in name.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h % n


class MdsTarget(R.Target):
    svc_kind = "mds"

    SPLIT_THRESHOLD = 1 << 30         # entries before a dir splits (set low
                                      # in tests; effectively off by default)
    SPLIT_WAYS = 4

    def __init__(self, uuid: str, node: R.Node, inode_group: int,
                 peers: dict | None = None):
        super().__init__(uuid, node)
        self.inode_group = inode_group
        self.inodes: dict[tuple, Inode] = {}
        self._ino_seq = itertools.count(2)
        self.rpc = R.RpcClient(node)
        self.ldlm = dlm_mod.LdlmNamespace(self, self.rpc,
                                          intent_policy=self.intent_policy)
        self.ldlm.conflict_cb = self._note_contention
        self.peers: dict[str, R.Import] = {}      # peer mds uuid -> import
        self.peer_nids: dict[str, list] = peers or {}
        self.unlink_llog = llog_mod.LlogCatalog(f"{uuid}-unlink")
        # consumer bookmarks are journaled with the catalog header: the
        # register/clear/deregister header updates run through this MDT's
        # transaction machinery (crash-atomic with the purge they imply)
        self.changelog = cl_mod.Changelog(uuid, txn=self.txn,
                                          now=lambda: self.sim.now)
        # highest transno of THIS mds known to be inside the CLUSTER-wide
        # committed consistent cut (§6.7.6.3): changelog_read never serves
        # a record above it, so a multi-MDT rollback cannot retract a
        # record a consumer has already seen
        self.cluster_cut = 0
        # cut-derivation cache: deriving the cut costs O(peers) RPCs, so
        # the serving path re-derives at most once per `cut_staleness`
        # virtual seconds; a local commit invalidates (new records may
        # now enter the cut), a snapshot()/prune_history push refreshes
        self.cut_staleness = 0.05
        self._cut_checked_at: float | None = None
        self.commit_callbacks.append(self._cut_cache_invalidate)
        # dependency records for the consistent cut (§6.7.6.3):
        # [(own_transno, {peer_uuid: peer_transno})]
        self.dep_log: list[tuple[int, dict]] = []
        self.undo_history: list[tuple[int, Any]] = []   # kept past commit
        # batch-collection mode (op_reint_batch): while set, txn_meta
        # accumulates (undo, deps) here instead of opening transactions,
        # so the whole batch lands as ONE undo-scoped transaction
        self._batch_txn: dict | None = None
        self.contention: dict[tuple, int] = {}    # fid -> recent conflicts
        self.osts: dict[str, R.Import] = {}       # for orphan cleanup
        if inode_group == 0:
            root = Inode(ROOT_FID, S_IFDIR, mode=0o755, nlink=2)
            self.inodes[ROOT_FID] = root
        ops = self.ops
        ops["getattr"] = self.op_getattr
        ops["getattr_bulk"] = self.op_getattr_bulk
        ops["readdir"] = self.op_readdir
        ops["reint"] = self.op_reint
        ops["reint_batch"] = self.op_reint_batch
        ops["close"] = self.op_close
        ops["statfs"] = self.op_statfs
        ops["wbc_request"] = self.op_wbc_request
        ops["prealloc_fids"] = self.op_prealloc_fids
        ops["llog_cancel"] = self.op_llog_cancel
        ops["bucket_insert"] = self.op_bucket_insert
        ops["bucket_lookup"] = self.op_bucket_lookup
        ops["bucket_remove"] = self.op_bucket_remove
        ops["remote_mkdir"] = self.op_remote_mkdir
        ops["remote_create"] = self.op_remote_create
        ops["remote_link"] = self.op_remote_link
        ops["remote_unlink_inode"] = self.op_remote_unlink_inode
        ops["dir_nonempty"] = self.op_dir_nonempty
        ops["remote_nlink_adjust"] = self.op_remote_nlink_adjust
        ops["revoke_dir_locks"] = self.op_revoke_dir_locks
        ops["dep_records"] = self.op_dep_records
        ops["rollback_to"] = self.op_rollback_to
        ops["prune_history"] = self.op_prune_history
        ops["sync_commit"] = self.op_sync_commit
        ops["peer_rebooted"] = self.op_peer_rebooted
        ops["changelog_register"] = self.op_changelog_register
        ops["changelog_deregister"] = self.op_changelog_deregister
        ops["changelog_read"] = self.op_changelog_read
        ops["changelog_clear"] = self.op_changelog_clear

    # ------------------------------------------------------------- wiring
    def connect_peer(self, uuid: str, nids: list[str]):
        self.peer_nids[uuid] = nids

    def _peer(self, uuid: str) -> R.Import:
        imp = self.peers.get(uuid)
        if imp is None:
            imp = self.rpc.import_target(uuid, self.peer_nids[uuid], "mds")
            # a peer evicting this import loses our replayable cross-MDT
            # halves: cross-check the namespace halves right away
            imp.evict_cbs.append(lambda u=uuid: self._peer_evicted(u))
            self.peers[uuid] = imp
        return imp

    def _peer_evicted(self, peer_uuid: str):
        """Our MDS-MDS import got evicted (-107): the replay queue died
        with it, so cross-MDT halves this side already applied may now
        dangle (entry here, inode lost over there). Run the ROADMAP'd
        post-eviction namespace cross-check against that peer."""
        self.sim.stats.count("mds.peer_evicted")
        self.namespace_crosscheck(peer_uuid)

    def namespace_crosscheck(self, peer_uuid: str) -> int:
        """Verify every dirent pointing at an inode the peer owns still
        resolves there; drop dangling entries (the state a lost replay
        queue leaves behind). An unreachable peer proves nothing — those
        entries are kept. Returns the number of entries dropped."""
        dropped = 0
        imp = self._peer(peer_uuid)
        for ino in list(self.inodes.values()):
            if ino.ftype != S_IFDIR:
                continue
            for name, fid in list(ino.entries.items()):
                fid = tuple(fid)
                if fid[0] == self.inode_group or fid in self.inodes:
                    continue
                if self._peer_for_group(fid[0]) != peer_uuid:
                    continue
                try:
                    imp.request("getattr", {"fid": fid}, no_recover=True)
                except R.RpcError as e:
                    if e.status == -2:       # the peer half is gone
                        ino.entries.pop(name, None)
                        dropped += 1
                except R.TimeoutError_:
                    pass                     # unreachable: keep the entry
        if dropped:
            self.sim.stats.count("mds.crosscheck_dropped", dropped)
        return dropped

    def connect_ost(self, uuid: str, nids: list[str]):
        self.osts[uuid] = self.rpc.import_target(uuid, nids, "ost")

    def on_restart(self):
        """A restarted MDS announces itself to its peers (the pinger's
        job in real Lustre, §4.4.2.5 — a synchronous stand-in here): each
        peer reconnects its MDS-MDS import, detects the reboot, and
        replays the cross-MDT halves this target lost, inside the
        recovery window. A target restarting while its node is still
        powered off (fail_node) cannot announce — peers learn of the
        reboot on next contact (-108) instead."""
        if self.node.nid in self.sim.faults.down_nids:
            return
        for uuid in self.peer_nids:
            try:
                self._peer(uuid).request("peer_rebooted",
                                         {"peer": self.uuid},
                                         no_recover=True)
            except (R.RpcError, R.TimeoutError_):
                pass

    def op_peer_rebooted(self, req: R.Request) -> R.Reply:
        """Peer notification: our import to `peer` is stale — reconnect
        now (detecting the reboot) so our half-transactions replay into
        its recovery window instead of waiting for the next cross-MDT
        operation to stumble over -108."""
        imp = self.peers.get(req.body.get("peer", ""))
        if imp is not None:
            # a FULL import must drop its now-stale connection first; a
            # DISCONN one (we noticed the outage mid-flap and nothing
            # retried since) just needs the reconnect kick
            if imp.state == "FULL":
                imp.state = "DISCONN"
            try:
                imp._connect_cycle()       # detects reboot -> replays
            except R.TimeoutError_:
                pass
        # a peer reboot changes what the cut can prove: drop the cached
        # derivation so the next gated read re-derives immediately
        self._cut_checked_at = None
        return R.Reply()

    # --------------------------------------------------------------- fids
    def new_fid(self) -> tuple:
        ino = next(self._ino_seq)
        return (self.inode_group, ino, 1)

    def _get(self, fid) -> Inode:
        ino = self.inodes.get(tuple(fid))
        if ino is None:
            raise R.RpcError(-2, f"no inode {fid}")      # ENOENT
        return ino

    # --------------------------------------------------------- changelog
    def _cl(self, req: Optional[R.Request], cl_type: str, fid, *,
            pfid=None, name: str = "", **extra):
        """Emit one changelog record attributed to the requesting client.
        Returns the record (or None while no consumer is registered) —
        the caller's transaction undo MUST retract it so an aborted or
        rolled-back reint leaves no phantom record. For MDS-MDS halves of
        cross-MDT ops the coordinator forwards the real originator in the
        request body (origin_client/origin_jobid); otherwise the requester
        IS the originator. Every emit site opens its transaction right
        after emitting, so the owning transno is the next one."""
        # the idle-consumer sweep runs BEFORE the owning transno below is
        # computed: a collected consumer's deregister is its own header
        # transaction and would otherwise skew transno + 1
        self.changelog.maybe_gc()
        client = jobid = ""
        if req is not None:
            client = req.body.get("origin_client", req.client_uuid)
            jobid = req.body.get("origin_jobid", req.jobid)
        return self.changelog.emit(
            cl_type, fid, pfid=pfid, name=name, time=self.sim.now,
            client=client, jobid=jobid, transno=self.transno + 1, **extra)

    def _cl_origin(self, req: Optional[R.Request]) -> dict:
        """Origin fields a coordinator forwards with MDS-MDS requests so
        the peer's record half attributes the real client, not the
        internal MDS RpcClient."""
        if req is None:
            return {}
        return {"origin_client": req.body.get("origin_client",
                                              req.client_uuid),
                "origin_jobid": req.body.get("origin_jobid", req.jobid)}

    def _cl_stabilize(self, recs):
        """A record handed to a consumer (or purged on its behalf) must
        be durable first — commit the journal if any of `recs` is still
        in the uncommitted tail, so nothing a consumer has seen can be
        rolled back by a crash."""
        if any(r.transno > self.committed_transno for r in recs):
            self.commit()

    # ------------------------------------------ cluster-cut record gating
    def _collect_dep_states(self) -> dict:
        """Own + peer (committed, dep-vector) states for the consistent-cut
        computation. An unreachable peer contributes committed=0: its
        halves cannot be proven durable, so nothing depending on them is
        served until it returns."""
        states = {self.uuid: {"committed": self.committed_transno,
                              "deps": [(t, dict(d))
                                       for t, d in self.dep_log]}}
        self._last_collect_ok = True
        for uuid in self.peer_nids:
            try:
                states[uuid] = self._peer(uuid).request(
                    "dep_records", {}, no_recover=True).data
            except (R.RpcError, R.TimeoutError_):
                states[uuid] = {"committed": 0, "deps": []}
                self._last_collect_ok = False
        return states

    def _advance_cluster_cut(self, need: int):
        """Try to move the cluster-committed cut past transno `need`:
        compute the cut over everyone's dep records; if `need` is still
        excluded (some dependency's peer half uncommitted), ask the peers
        to flush their journals and recompute. The cut only advances —
        commits are durable, so a transno once inside it stays inside."""
        for attempt in range(2):
            states = self._collect_dep_states()
            cut = rec_mod.compute_consistent_cut(states).get(self.uuid, 0)
            if cut >= need or attempt:
                break
            for uuid in self.peer_nids:       # force the blocking halves out
                try:
                    self._peer(uuid).request("sync_commit", {},
                                             no_recover=True)
                except (R.RpcError, R.TimeoutError_):
                    pass
        self.cluster_cut = max(self.cluster_cut, cut)
        # cache only a FULL round: with a peer unreachable nothing was
        # proven — the next read must retry, not trust a stale failure
        self._cut_checked_at = self.sim.now \
            if getattr(self, "_last_collect_ok", True) else None

    def _cut_cache_invalidate(self, committed: int | None = None):
        self._cut_checked_at = None

    def _cut_stale(self) -> bool:
        return self._cut_checked_at is None or \
            self.sim.now - self._cut_checked_at >= self.cut_staleness

    def _gate_at_cluster_cut(self, recs):
        """Serve only records at or below the CLUSTER-committed consistent
        cut (§6.7.6.3): local commit protects against single-MDT crashes,
        the cut protects against the multi-MDT rollback retracting a
        committed cross-MDT record a consumer already read. Records above
        the cut are withheld until it advances (they stay retained).

        The O(peers) dep-vector round runs at most once per
        `cut_staleness` window: a burst of gated reads pays ONE round,
        records above the cached cut are simply withheld until the window
        expires (or a commit/snapshot invalidates the cache)."""
        if not recs:
            return recs
        if not self.peer_nids:
            self._cl_stabilize(recs)      # single MDT: the commit IS the cut
            return recs
        hi = max(r.transno for r in recs)
        if hi > self.cluster_cut and self._cut_stale():
            if hi > self.committed_transno:
                # our own tail must be durable before it can enter the cut
                self.commit()
            self._advance_cluster_cut(hi)
        served = [r for r in recs if r.transno <= self.cluster_cut]
        self._cl_stabilize(served)        # no-op: cut <= committed
        return served

    def op_sync_commit(self, req: R.Request) -> R.Reply:
        """Peer-requested journal flush (a serving MDS forcing the peer
        halves of cross-MDT transactions into the consistent cut)."""
        self.commit()
        return R.Reply(data={"committed": self.committed_transno})

    def op_changelog_register(self, req: R.Request) -> R.Reply:
        uid = self.changelog.register()
        # the id handed back must survive a restart: commit the header txn
        self.commit()
        # transno-bearing so the reply cache absorbs resends: a register
        # whose reply was lost must NOT mint a second consumer (whose
        # stale bookmark would pin the stream until idle GC)
        return R.Reply(data={"id": uid, "last_idx": self.changelog.last_idx},
                       transno=self.transno)

    def op_changelog_deregister(self, req: R.Request) -> R.Reply:
        try:
            self.changelog.deregister(req.body["id"])
        except KeyError:
            raise R.RpcError(-2, req.body.get("id", ""))
        # like register/clear: the ack must be durable, or a crash would
        # resurrect the consumer (whose stale bookmark pins the stream)
        self.commit()
        # reply-cache-covered: a resent deregister must be answered from
        # the cache, not re-executed into a spurious -ENOENT
        return R.Reply(transno=self.transno)

    def op_changelog_read(self, req: R.Request) -> R.Reply:
        b = req.body
        if b.get("id") not in self.changelog.users:
            raise R.RpcError(-2, b.get("id", ""))
        self.changelog.touch(b["id"])
        since = b.get("since_idx")
        if since is None:
            # default: everything the consumer has not cleared yet
            since = self.changelog.users[b["id"]]
        recs = self._gate_at_cluster_cut(
            self.changelog.read(since, b.get("count", 0)))
        # record payload moves like a bulk readdir page
        wire = [r.to_wire() for r in recs]
        return R.Reply(data={"records": wire,
                             "last_idx": self.changelog.last_idx},
                       bulk_nbytes=R.wire_size(wire))

    def op_changelog_clear(self, req: R.Request) -> R.Reply:
        uid = req.body.get("id")
        if uid not in self.changelog.users:
            raise R.RpcError(-22, uid or "")
        fail_mod.maybe_fail("mds.changelog.clear")
        up_to = req.body["up_to"]
        # purging is destructive: anything acked must be durable first —
        # locally AND inside the cluster cut (an ack above the cut is
        # clamped down; the consumer can only have seen served records)
        acked = [r for r in self.changelog.records() if r.idx <= up_to]
        served = self._gate_at_cluster_cut(acked)
        if len(served) < len(acked):
            up_to = max((r.idx for r in served),
                        default=self.changelog.users[uid])
        self.changelog.clear(uid, up_to)
        fail_mod.maybe_fail("mds.changelog.clear.applied")
        # journal the bookmark with the clear's transaction: the ack the
        # consumer receives is durable across MDS restart (no re-delivery
        # of cleared records after recovery)
        self.commit()
        # reply-cache-covered like every other update op
        return R.Reply(data={"purged_to": self.changelog.purged_to,
                             "records": len(self.changelog.catalog.pending())},
                       transno=self.transno)

    # ---------------------------------------------------- txn w/ history
    def crash(self):
        super().crash()
        # the rolled-back tail's retained-undo/dependency entries are
        # dead — their undos already ran, and REPLAY will reuse their
        # transnos with fresh closures; keeping both would double-undo
        # on a later consistent-cut rollback
        self.undo_history = [(t, u) for t, u in self.undo_history
                             if t <= self.committed_transno]
        self.dep_log = [(t, d) for t, d in self.dep_log
                        if t <= self.committed_transno]

    def txn_meta(self, undo, deps: dict | None = None) -> int:
        """A metadata transaction: normal undo (crash rollback) + retained
        undo history + dependency record for the consistent cut.

        In batch-collection mode (op_reint_batch) nothing is opened:
        the (undo, deps) pair is parked on the batch and the would-be
        batch transno is returned — `self.transno` does not advance, so
        every changelog emit in the batch stamps the SAME transno."""
        if self._batch_txn is not None:
            self._batch_txn["undos"].append(undo)
            if deps:
                bd = self._batch_txn["deps"]
                for peer, t in deps.items():
                    bd[peer] = max(bd.get(peer, 0), t)
            return self.transno + 1
        transno = self.txn(undo)
        self.undo_history.append((transno, undo))
        if deps:
            self.dep_log.append((transno, dict(deps)))
        if len(self.undo_history) > 4096:
            self.undo_history = self.undo_history[-2048:]
        return transno

    # ------------------------------------------------------------ intents
    def intent_policy(self, req: R.Request, res) -> tuple[dict, bool]:
        """DLM intent execution (§7.5): run the operation while granting.
        Returns (intent_data, grant_lock)."""
        it = req.body["intent"]
        op = it["op"]
        self.sim.stats.count(f"mds.intent.{op}")
        if op == "lookup" or op == "getattr":
            data = self._intent_lookup(it)
            return data, data.get("status", 0) == 0
        if op == "readdir":
            data = self._intent_readdir(it)
            return data, data.get("status", 0) == 0
        if op == "open":
            data = self._intent_open(it, req)
            return data, data.get("status", 0) == 0 and not it.get("no_lock")
        if op == "wbc":
            granted = self._wbc_decision(tuple(it["fid"]))
            return {"wbc_granted": granted}, granted
        return {"status": -38}, False

    def _intent_lookup(self, it) -> dict:
        parent = self.inodes.get(tuple(it["parent"]))
        if parent is None:
            return {"status": -2}
        name = it["name"]
        if "buckets" in parent.ea:
            b = parent.ea["buckets"]
            bfid = b[fhash(name, len(b))]
            if tuple(bfid)[0] != self.inode_group:
                return {"status": 0, "redirect": bfid}
            parent = self._get(bfid)
        fid = parent.entries.get(name)
        if fid is None:
            # negative dentry: cacheable non-existence (§6.2.1)
            return {"status": -2, "negative": True}
        inode = self.inodes.get(tuple(fid))
        if inode is None:
            return {"status": 0, "fid": fid, "remote": True}
        d = {"status": 0, "attrs": inode.attrs()}
        if it.get("want_ea"):
            d["ea"] = dict(inode.ea)
        return d

    def _intent_readdir(self, it) -> dict:
        """readdir-plus: ONE page of directory entries, each
        carrying the entry's attributes (+ EA with the LOV stripe
        descriptor) when its inode lives on THIS MDT, served under the
        directory's PR lock the enqueue grants. Entries whose inode a
        peer MDT owns are flagged `remote` — the LMV batch-resolves them
        with ONE getattr_bulk per owning MDT, not one RPC per name. A
        split directory returns its bucket fids; the LMV pages each
        bucket at ITS MDS the same way (one page per MDT)."""
        inode = self.inodes.get(tuple(it["fid"]))
        if inode is None:
            return {"status": -2}
        if inode.ftype != S_IFDIR:
            return {"status": -20}                      # ENOTDIR
        page = max(1, int(it.get("page_size") or 64))
        names = sorted(inode.entries)
        # name cursor, not a numeric index: a create/unlink between two
        # page RPCs must not shift later pages (an index cursor would
        # skip or duplicate entries that existed for the whole scan)
        after = it.get("after")
        if after is not None:
            names = names[bisect.bisect_right(names, after):]
        entries = {}
        for name in names[:page]:
            fid = tuple(inode.entries[name])
            child = self.inodes.get(fid)
            e = {"fid": fid}
            if child is None:
                e["remote"] = True
            else:
                child.pfids.add(inode.fid)
                e["attrs"] = child.attrs()
                if it.get("want_ea"):
                    e["ea"] = dict(child.ea)
            entries[name] = e
        d = {"status": 0, "entries": entries,
             "next": names[page - 1] if len(names) > page else None,
             "buckets": inode.ea.get("buckets")}
        self.sim.stats.count("mds.readdir_plus_entries", len(entries))
        return d

    def op_getattr_bulk(self, req: R.Request) -> R.Reply:
        """Batched getattr: attrs (+EA) for MANY fids in ONE RPC — the
        statahead prefetch and the LMV's cross-MDT readdir-plus merge
        ride on this instead of a getattr per name. Unknown fids answer
        None (the caller falls back per entry)."""
        out = []
        for f in req.body["fids"]:
            ino = self.inodes.get(tuple(f))
            if ino is None:
                out.append(None)
                continue
            d = {"attrs": ino.attrs()}
            if req.body.get("want_ea"):
                d["ea"] = dict(ino.ea)
            out.append(d)
        self.sim.stats.count("mds.getattr_bulk_fids", len(out))
        return R.Reply(data={"attrs": out}, bulk_nbytes=R.wire_size(out))

    def _intent_open(self, it, req: R.Request) -> dict:
        """open_namei work: lookup [+create] + open (§6.4.3). Returns the
        `disposition` bitmap of which phases ran. An entry whose inode a
        peer MDT owns (the state a cross-MDT rename leaves behind) gets
        the `_intent_lookup`-style remote redirect: the LMV re-issues the
        open BY FID at the owning MDT (`by_fid`)."""
        flags = it.get("flags", "")
        if it.get("by_fid"):
            # redirected second hop: open the inode this MDT owns directly
            disp = ["open"]
            inode = self.inodes.get(tuple(it["fid"]))
            if inode is None:
                return {"status": -2, "disposition": disp}
            return self._open_tail(inode, flags, req, disp,
                                   created=False, transno=0)
        disp = ["lookup"]
        parent = self._get(it["parent"])
        name = it["name"]
        fid = parent.entries.get(name)
        if fid is None and "buckets" in parent.ea:
            b = parent.ea["buckets"]
            bfid = b[fhash(name, len(b))]
            bucket = self.inodes.get(tuple(bfid))
            if bucket is not None:
                fid = bucket.entries.get(name)
        created = False
        if fid is None:
            if "c" not in flags:
                return {"status": -2, "disposition": disp}
            disp.append("create")
            # the create changes the parent's OWN attrs (nentries) too:
            # revoke the locks covering cached copies of them as well
            self._revoke_client_locks(parent.fid, *parent.pfids,
                                      exclude=self._requester(req))
            fid = tuple(it["fid"]) if it.get("fid") else self.new_fid()
            inode = Inode(fid, S_IFREG, mode=it.get("mode", 0o644),
                          mtime=self.sim.now)
            self.inodes[fid] = inode
            self._dir_insert(parent, name, fid,
                             exclude=self._requester(req))
            created = True
            clrec = self._cl(req, cl_mod.CL_CREAT, fid, pfid=parent.fid,
                             name=name, mode=inode.mode)

            def undo():
                self._dir_remove_raw(parent, name)
                self.inodes.pop(fid, None)
                self.changelog.retract(clrec)
            transno = self.txn_meta(undo)
        else:
            if "x" in flags and "c" in flags:
                return {"status": -17, "disposition": disp}   # EEXIST
            fid = tuple(fid)
            if fid not in self.inodes and fid[0] != self.inode_group:
                # inode half lives on a peer MDT (cross-MDT rename
                # residue): redirect, exactly as _intent_lookup does
                return {"status": 0, "disposition": disp,
                        "remote": True, "fid": fid}
            transno = 0
        inode = self._get(fid)
        return self._open_tail(inode, flags, req, disp, created, transno)

    def _open_tail(self, inode: Inode, flags: str, req: R.Request,
                   disp: list, created: bool, transno: int) -> dict:
        """The open phase shared by the local and by-fid (redirected)
        paths: symlink short-circuit, per-export open handle, mtime
        delegation to the OSTs while open for write."""
        disp = disp + ["open"] if disp[-1] != "open" else disp
        if inode.ftype == S_IFLNK:
            return {"status": 0, "disposition": disp, "symlink": inode.symlink,
                    "attrs": inode.attrs()}
        exp = self.exports[req.client_uuid]
        handle = len(exp.data.setdefault("opens", {})) + 1
        exp.data["opens"][handle] = inode.fid
        if "w" in flags and inode.ftype == S_IFREG \
                and not inode.mtime_on_ost:
            # OSTs own mtime/size while open-write — clients caching the
            # old attrs (mtime_on_ost=False) would skip the OST glimpse
            # and serve a frozen size: revoke their covering dir locks
            self._revoke_client_locks(*inode.pfids,
                                      exclude=self._requester(req))
            self._revoke_remote_pfids(inode, req)
            inode.mtime_on_ost = True
        return {"status": 0, "disposition": disp, "created": created,
                "attrs": inode.attrs(), "ea": dict(inode.ea),
                "open_handle": handle, "_transno": transno}

    def _revoke_client_locks(self, *fids, exclude: str | None = None):
        """§6.4.2: the MDS takes a write lock on the parent directories (in
        fid order) before a namespace update — here that means revoking
        client PR locks (blocking ASTs) so cached dentries invalidate.

        `exclude` spares the REQUESTING client's own locks: it made the
        change and fixes its own caches locally (fsio drops the touched
        dentry/attr entries), so ASTing it back would only burn an RPC
        round trip per operation and tear down its whole-directory cache
        for nothing (the double-AST-per-create problem)."""
        for fid in sorted(set(tuple(f) for f in fids)):
            res = self.ldlm.resources.get(("fid", *fid))
            if not res:
                continue
            for lk in list(res.granted):
                if exclude is not None and lk.client_uuid == exclude:
                    continue
                if lk.mode in ("PR", "EX", "PW", "CW"):
                    ok = self.ldlm._blocking_ast(lk)
                    if not ok:
                        self.ldlm.evict_client(lk.client_uuid)
            self._note_contention(("fid", *fid))

    @staticmethod
    def _requester(req) -> str | None:
        """Client uuid to spare from cache revocation: the direct
        requester maintains its own caches after its own operation.
        This includes a WBC reint_batch — revoking the flusher's own
        subtree EX lock would tear down the write-back cache on its
        FIRST background flush; the client invalidates its pre-WBC
        dentry/attr entries itself when it applies a shadow update."""
        if req is None:
            return None
        return req.client_uuid

    def _note_contention(self, res_name: tuple):
        """Lock-callback traffic feeds the WBC switching policy (§6.5.2)."""
        if res_name and res_name[0] == "fid":
            fid = tuple(res_name[1:])
            self.contention[fid] = self.contention.get(fid, 0) + 1

    # ---------------------------------------------------------- wbc grant
    def _wbc_decision(self, fid: tuple) -> bool:
        """§6.5: default to a subtree (write-back) lock unless the resource
        saw recent lock-callback traffic."""
        return self.contention.get(fid, 0) < 2

    def op_wbc_request(self, req: R.Request) -> R.Reply:
        fid = tuple(req.body["fid"])
        ok = self._wbc_decision(fid)
        return R.Reply(data={"granted": ok})

    def op_prealloc_fids(self, req: R.Request) -> R.Reply:
        n = req.body.get("count", 64)
        fids = [self.new_fid() for _ in range(n)]
        return R.Reply(data={"fids": fids})

    # -------------------------------------------------------------- plain
    def op_getattr(self, req: R.Request) -> R.Reply:
        inode = self._get(req.body["fid"])
        d = {"attrs": inode.attrs()}
        if req.body.get("want_ea"):
            d["ea"] = dict(inode.ea)
        if inode.ftype == S_IFLNK:
            d["symlink"] = inode.symlink
        return R.Reply(data=d)

    def op_readdir(self, req: R.Request) -> R.Reply:
        inode = self._get(req.body["fid"])
        if inode.ftype != S_IFDIR:
            raise R.RpcError(-20)           # ENOTDIR
        entries = dict(inode.entries)
        nbytes = sum(len(k) + 24 for k in entries)
        # split dir: the LMV iterates the buckets client-side (§6.7.3);
        # bucket fids on THIS mds could be merged here, but uniform
        # client-side iteration keeps the protocol single-shaped.
        return R.Reply(data={"entries": entries, "buckets":
                             inode.ea.get("buckets")}, bulk_nbytes=nbytes)

    def op_statfs(self, req: R.Request) -> R.Reply:
        return R.Reply(data={"inodes": len(self.inodes),
                             "group": self.inode_group})

    # ---------------------------------------------------------- monitor
    def mon_stats(self) -> dict:
        return {
            "namespace": {"inodes": len(self.inodes),
                          "inode_group": self.inode_group,
                          "pending_unlink_llog":
                              len(self.unlink_llog.pending())},
            "locks": {
                "resources": len(self.ldlm.resources),
                "granted": sum(len(r.granted)
                               for r in self.ldlm.resources.values()),
                "waiting": sum(len(r.waiting)
                               for r in self.ldlm.resources.values()),
            },
            "changelog": self.changelog.info(),
            "cluster_cut": self.cluster_cut,
        }

    def op_close(self, req: R.Request) -> R.Reply:
        exp = self.exports[req.client_uuid]
        fid = exp.data.get("opens", {}).pop(req.body.get("handle"), None)
        if fid is None and req.body.get("fid"):
            # replay after server restart: open-handle table was volatile,
            # the request carries the fid (§29: open replay)
            fid = tuple(req.body["fid"])
            if fid not in self.inodes:
                fid = None
        b = req.body
        if fid is not None and (b.get("size") is not None
                                or b.get("mtime") is not None):
            inode = self._get(fid)
            # size/mtime land on the MDS (and mtime_on_ost flips off):
            # cached attrs under the parents' dir locks are stale now
            self._revoke_client_locks(*inode.pfids,
                                      exclude=self._requester(req))
            self._revoke_remote_pfids(inode, req)
            old = (inode.size, inode.mtime, inode.mtime_on_ost)
            if b.get("size") is not None:
                inode.size = b["size"]
            if b.get("mtime") is not None:
                inode.mtime = max(inode.mtime, b["mtime"])
            inode.mtime_on_ost = False
            clrec = self._cl(req, cl_mod.CL_CLOSE, fid,
                             size=inode.size, mtime=inode.mtime)

            def undo():
                inode.size, inode.mtime, inode.mtime_on_ost = old
                self.changelog.retract(clrec)
            return R.Reply(transno=self.txn_meta(undo))
        return R.Reply()

    # ---------------------------------------------------- VBR
    @staticmethod
    def _vbr_rec_keys(r: dict) -> list:
        """The inodes one reint record mutates: the parent dir(s) whose
        entry set changes and the target inode whose attrs change."""
        keys = []
        for f in ("parent", "fid", "src", "dst"):
            v = r.get(f)
            if v is not None:
                k = ("ino",) + tuple(v)
                if k not in keys:
                    keys.append(k)
        return keys

    def vbr_keys_for(self, req: R.Request) -> list:
        op = req.opcode
        if op == "reint":
            return self._vbr_rec_keys(req.body.get("rec") or {})
        if op == "reint_batch":
            keys: list = []
            seen: set = set()
            for r in req.body.get("records", ()):
                for k in self._vbr_rec_keys(r):
                    if k not in seen:
                        seen.add(k)
                        keys.append(k)
            return keys
        if op == "close":
            b = req.body
            if b.get("size") is None and b.get("mtime") is None:
                return []                  # attr-less close: no txn
            exp = self.exports.get(req.client_uuid)
            fid = None
            if exp is not None:
                fid = exp.data.get("opens", {}).get(b.get("handle"))
            if fid is None and b.get("fid"):
                fid = tuple(b["fid"])
            return [("ino",) + tuple(fid)] if fid is not None else []
        return []

    # ----------------------------------------------------- reintegration
    def op_reint(self, req: R.Request) -> R.Reply:
        fail_mod.maybe_fail("mds.reint.before")
        r = req.body["rec"]
        fn = getattr(self, f"_reint_{r['type']}", None)
        if fn is None:
            raise R.RpcError(-38, r["type"])
        self.sim.stats.count(f"mds.reint.{r['type']}")
        return fn(r, req)

    def op_reint_batch(self, req: R.Request) -> R.Reply:
        """WBC flush: apply update records in order as ONE undo-scoped
        transaction (ch. 17, §6.5.3) with per-record status.

        Batch-collection mode diverts every record's txn_meta into an
        accumulator (transno frozen), so all changelog emits stamp the
        single batch transno; one real txn_meta at the end installs a
        composite undo running the records' undos in reverse. The reply
        carries that transno, so the batch rides the ordinary reply
        cache + replay machinery: a resend is answered from the cache, an
        MDS crash rolls the whole batch back and client replay re-applies
        it exactly once. A record that fails (e.g. EEXIST) contributes
        only its -errno status — its partial effects (none today: every
        handler checks before mutating) are unwound record-locally."""
        out = []
        self._batch_txn = {"undos": [], "deps": {}}
        try:
            for r in req.body["records"]:
                fail_mod.maybe_fail("mds.reint_batch")
                fn = getattr(self, f"_reint_{r['type']}", None)
                if fn is None:
                    out.append({"status": -38, "data": None})
                    continue
                self.sim.stats.count(f"mds.reint.{r['type']}")
                n0 = len(self._batch_txn["undos"])
                try:
                    rep = fn(r, req)
                    out.append({"status": rep.status, "data": rep.data})
                except R.RpcError as e:
                    # record-local rollback: a failing record must not
                    # leave half-applied state inside the batch
                    for u in reversed(self._batch_txn["undos"][n0:]):
                        u()
                    del self._batch_txn["undos"][n0:]
                    out.append({"status": e.status, "data": None})
        except BaseException:
            # induced crash (FailLocHit) or bug mid-batch: no transaction
            # was opened yet, so the target's undo_log knows nothing of
            # the applied records — unwind them here before propagating
            for u in reversed(self._batch_txn["undos"]):
                u()
            self._batch_txn = None
            raise
        bt, self._batch_txn = self._batch_txn, None
        if not bt["undos"]:
            return R.Reply(data={"results": out})

        def undo_batch():
            for u in reversed(bt["undos"]):
                u()
        transno = self.txn_meta(undo_batch, bt["deps"] or None)
        return R.Reply(data={"results": out}, transno=transno)

    def _dir_insert(self, parent: Inode, name: str, fid: tuple,
                    is_dir: bool = False, exclude: str | None = None):
        child = self.inodes.get(tuple(fid))
        if child is not None:
            # the master dir's PR lock covers clients' cached attrs of
            # this child (readdir-plus / statahead): remember it so a
            # later setattr/close revokes that lock
            child.pfids.add(parent.fid)
        if "buckets" in parent.ea:
            b = parent.ea["buckets"]
            bfid = tuple(b[fhash(name, len(b))])
            if bfid[0] == self.inode_group:
                self._get(bfid).entries[name] = fid
                if child is not None:
                    child.pfids.add(bfid)       # bucket lock covers too
                self._revoke_client_locks(bfid, exclude=exclude)
            else:
                peer = self._peer_for_group(bfid[0])
                rep = self._peer(peer).request(
                    "bucket_insert", {"bucket": bfid, "name": name,
                                      "fid": fid, "exclude": exclude})
                # cross-MDS dependency: our txn depends on the peer's
                self._last_deps = {peer: rep.transno}
            parent.entries.pop(name, None)
        else:
            parent.entries[name] = fid
            if len(parent.entries) > self.SPLIT_THRESHOLD and self.peer_nids:
                self._split_dir(parent)
        if is_dir:
            parent.nlink += 1

    def _dir_remove_raw(self, parent: Inode, name: str,
                        exclude: str | None = None):
        if "buckets" in parent.ea:
            b = parent.ea["buckets"]
            bfid = tuple(b[fhash(name, len(b))])
            if bfid[0] == self.inode_group:
                self._get(bfid).entries.pop(name, None)
                self._revoke_client_locks(bfid, exclude=exclude)
            else:
                peer = self._peer_for_group(bfid[0])
                rep = self._peer(peer).request(
                    "bucket_remove", {"bucket": bfid, "name": name,
                                      "exclude": exclude})
                self._last_deps = {peer: rep.transno}
        else:
            parent.entries.pop(name, None)

    def _lookup_entry(self, parent: Inode, name: str):
        if "buckets" in parent.ea:
            b = parent.ea["buckets"]
            bfid = tuple(b[fhash(name, len(b))])
            if bfid[0] == self.inode_group:
                return self._get(bfid).entries.get(name)
            peer = self._peer_for_group(bfid[0])
            rep = self._peer(peer).request(
                "bucket_lookup", {"bucket": bfid, "name": name})
            f = rep.data.get("fid")
            return tuple(f) if f else None
        f = parent.entries.get(name)
        return tuple(f) if f else None

    def _peer_for_group(self, group: int) -> str:
        for uuid in self.peer_nids:
            if uuid.endswith(str(group)) or f"-{group}" in uuid:
                return uuid
        return list(self.peer_nids)[group % max(1, len(self.peer_nids))]

    # --- create family
    def _reint_create(self, r, req) -> R.Reply:
        parent = self._get(r["parent"])
        name = r["name"]
        # parent.fid: the dentries/attrs cached under the dir's lock;
        # parent.pfids: the parent's OWN cached attrs (nlink/nentries
        # change with this create) under ITS parents' locks
        self._revoke_client_locks(parent.fid, *parent.pfids,
                                  exclude=self._requester(req))
        if self._lookup_entry(parent, name) is not None:
            raise R.RpcError(-17, name)
        ftype = r.get("ftype", S_IFREG)
        self._last_deps = None
        if ftype == S_IFDIR and self.peer_nids and not r.get("fid") \
                and r.get("remote_ok", True):
            return self._mkdir_remote(parent, name, r, req)
        fid = tuple(r["fid"]) if r.get("fid") else self.new_fid()
        if fid[0] != self.inode_group:
            # replay of a remote-MDS create: re-create the pinned fid on
            # its owning peer (idempotent there), then re-insert locally
            peer = self._peer_for_group(fid[0])
            rep = self._peer(peer).request(
                "remote_mkdir" if ftype == S_IFDIR else "remote_create",
                {"mode": r.get("mode", 0o644), "fid": fid,
                 "ftype": ftype, "pfid": parent.fid,
                 "pfid_owner": self.uuid, **self._cl_origin(req)})
            self._dir_insert(parent, name, fid, is_dir=ftype == S_IFDIR,
                             exclude=self._requester(req))
            deps = {peer: rep.transno} if rep.transno else None
            clrec = self._cl(req, _cl_create_type(ftype), fid,
                             pfid=parent.fid, name=name)

            def undo_remote():
                self._dir_remove_raw(parent, name)
                if ftype == S_IFDIR:
                    parent.nlink -= 1
                self.changelog.retract(clrec)
            return R.Reply(data={"fid": fid},
                           transno=self.txn_meta(undo_remote, deps))
        inode = Inode(fid, ftype, mode=r.get("mode", 0o644),
                      mtime=self.sim.now,
                      nlink=2 if ftype == S_IFDIR else 1)
        if ftype == S_IFLNK:
            inode.symlink = r.get("target", "")
        if r.get("ea"):
            inode.ea.update(r["ea"])
        self.inodes[fid] = inode
        self._dir_insert(parent, name, fid, is_dir=ftype == S_IFDIR,
                         exclude=self._requester(req))
        deps = self._last_deps
        clrec = self._cl(req, _cl_create_type(ftype), fid, pfid=parent.fid,
                         name=name, mode=inode.mode)

        def undo():
            self._dir_remove_raw(parent, name)
            self.inodes.pop(fid, None)
            if ftype == S_IFDIR:
                parent.nlink -= 1
            self.changelog.retract(clrec)
        transno = self.txn_meta(undo, deps)
        self.ldlm.bump_version(("fid", *parent.fid))
        return R.Reply(data={"fid": fid}, transno=transno)

    def _mkdir_remote(self, parent: Inode, name: str, r,
                      req: Optional[R.Request] = None) -> R.Reply:
        """§6.7.1.2: 'mkdir always creates the new directory on another
        MDS'. Two-node transaction with a dependency record."""
        peer = sorted(self.peer_nids)[
            len(parent.entries) % len(self.peer_nids)]
        rep = self._peer(peer).request(
            "remote_mkdir", {"mode": r.get("mode", 0o755),
                             "pfid": parent.fid, "pfid_owner": self.uuid,
                             **self._cl_origin(req)},
            fixup=_pin_remote_fid)
        fid = tuple(rep.data["fid"])
        self._dir_insert(parent, name, fid, is_dir=True,
                         exclude=self._requester(req))
        deps = {peer: rep.transno}
        # the COORDINATOR (namespace side) logs the name-bearing record;
        # the peer logged only an inode-half record (remote=True)
        clrec = self._cl(req, cl_mod.CL_MKDIR, fid, pfid=parent.fid,
                         name=name)

        def undo():
            self._dir_remove_raw(parent, name)
            parent.nlink -= 1
            self.changelog.retract(clrec)
        transno = self.txn_meta(undo, deps)
        return R.Reply(data={"fid": fid, "remote": True}, transno=transno)

    def op_remote_mkdir(self, req: R.Request) -> R.Reply:
        fid = tuple(req.body["fid"]) if req.body.get("fid") else \
            self.new_fid()
        if fid in self.inodes:                  # idempotent replay
            return R.Reply(data={"fid": fid})
        ftype = req.body.get("ftype", S_IFDIR)
        inode = Inode(fid, ftype, mode=req.body.get("mode", 0o755),
                      nlink=2 if ftype == S_IFDIR else 1,
                      mtime=self.sim.now)
        if req.body.get("pfid"):
            # the coordinator's directory links us: attr changes here
            # must reach ITS clients' caches (revocation forwarding)
            inode.remote_pfids.add((req.body["pfid_owner"],
                                    tuple(req.body["pfid"])))
        self.inodes[fid] = inode
        # inode half of a cross-MDT create: nameless, flagged remote so
        # namespace consumers (audit mirror) don't double-apply it
        clrec = self._cl(req, _cl_create_type(ftype), fid, remote=True)

        def undo():
            self.inodes.pop(fid, None)
            self.changelog.retract(clrec)
        return R.Reply(data={"fid": fid}, transno=self.txn_meta(undo))

    op_remote_create = op_remote_mkdir

    # --- unlink family
    def _dir_nonempty(self, inode: Inode) -> bool:
        """THE 'directory still has content' predicate (ENOTEMPTY source
        of truth, shared by unlink / remote unlink / rename-over): own
        entries, or any entry in a hash bucket — local buckets read
        directly, remote ones via getattr (nentries)."""
        if inode.entries:
            return True
        for bfid in inode.ea.get("buckets", []):
            bfid = tuple(bfid)
            if bfid[0] == self.inode_group:
                b = self.inodes.get(bfid)
                if b is not None and b.entries:
                    return True
            else:
                try:
                    a = self._peer(self._peer_for_group(bfid[0])).request(
                        "getattr", {"fid": bfid}).data["attrs"]
                except R.RpcError as e:
                    if e.status == -2:
                        continue       # bucket inode gone: nothing there
                    raise R.RpcError(-16, "bucket unreachable")  # EBUSY
                except R.TimeoutError_:
                    # an unreachable bucket cannot prove emptiness —
                    # refusing (EBUSY) beats destroying live entries
                    raise R.RpcError(-16, "bucket unreachable")
                if a["nentries"]:
                    return True
        return False

    def op_dir_nonempty(self, req: R.Request) -> R.Reply:
        """Read-only: authoritative emptiness answer for a directory this
        MDT owns (cross-MDT rename-over prechecks ask here)."""
        inode = self.inodes.get(tuple(req.body["fid"]))
        if inode is None:
            return R.Reply(data={"exists": False, "nonempty": False})
        return R.Reply(data={
            "exists": True,
            "nonempty": inode.ftype == S_IFDIR
            and self._dir_nonempty(inode)})

    def op_revoke_dir_locks(self, req: R.Request) -> R.Reply:
        """Peer-forwarded attr revocation: a cross-MDT child of a dir
        THIS MDT owns changed its attrs over there — revoke the dir's
        client PR locks so no scan cache serves the old copy."""
        self._revoke_client_locks(tuple(req.body["fid"]),
                                  exclude=req.body.get("exclude") or None)
        return R.Reply()

    def _revoke_remote_pfids(self, inode: Inode,
                             req: Optional[R.Request] = None):
        """Forward the attr revocation to every peer-owned directory
        linking this inode (best effort: an unreachable peer's clients
        re-fetch when their locks lapse; its namespace half is already
        withheld from the consistent cut anyway)."""
        for owner, pfid in list(inode.remote_pfids):
            try:
                self._peer(owner).request(
                    "revoke_dir_locks",
                    {"fid": tuple(pfid),
                     "exclude": self._requester(req)},
                    no_recover=True)
            except (R.RpcError, R.TimeoutError_):
                self.sim.stats.count("mds.remote_revoke_skipped")

    def op_remote_nlink_adjust(self, req: R.Request) -> R.Reply:
        """'..'-link accounting half of a cross-MDT rename: the
        coordinator moved/removed a subdirectory of a dir THIS MDT
        owns."""
        inode = self._get(req.body["fid"])
        delta = int(req.body["delta"])
        self._revoke_client_locks(*inode.pfids)   # cached nlink is stale
        inode.nlink += delta

        def undo():
            inode.nlink -= delta
        return R.Reply(transno=self.txn_meta(undo))

    def _remote_nlink(self, fid: tuple, delta: int, deps: dict):
        """Best-effort '..' accounting on a peer-owned parent dir; the
        peer half joins the consistent cut via `deps`. A peer failure
        leaves an nlink drift rather than aborting the caller's
        already-applied rename."""
        peer = self._peer_for_group(fid[0])
        try:
            rep = self._peer(peer).request(
                "remote_nlink_adjust", {"fid": fid, "delta": delta})
            deps[peer] = max(deps.get(peer, 0), rep.transno)
        except (R.RpcError, R.TimeoutError_):
            self.sim.stats.count("mds.remote_nlink_skipped")

    def _victim_empty_or_raise(self, vfid: tuple, name: str):
        """Rename-over guard: the displaced target must be an empty
        directory (or a non-directory) — POSIX ENOTEMPTY, checked BEFORE
        any mutation, asking the victim's MDT when its inode is remote.
        Must be at least as strict as op_remote_unlink_inode so the
        post-mutation victim unlink can never be refused."""
        inode = self.inodes.get(vfid)
        if inode is not None:
            if inode.ftype == S_IFDIR and self._dir_nonempty(inode):
                raise R.RpcError(-39, name)
            return
        if vfid[0] == self.inode_group:
            return                     # locally owned but gone: stale entry
        try:
            d = self._peer(self._peer_for_group(vfid[0])).request(
                "dir_nonempty", {"fid": vfid}).data
        except R.RpcError as e:
            if e.status == -2:
                return                 # victim inode already gone
            raise                      # EBUSY etc: cannot prove empty
        except R.TimeoutError_:
            # nothing has mutated yet: refusing is safe, clobbering a
            # possibly non-empty dir is not
            raise R.RpcError(-16, name)
        if d["nonempty"]:
            raise R.RpcError(-39, name)

    def _drop_last_link(self, inode: Inode, data: dict,
                        req: Optional[R.Request] = None,
                        deps: dict | None = None):
        """Last link gone: drop the inode — a (drained) split dir dies
        with its hash buckets — and log one orphan-recovery llog record
        per data object (§6.7.5); `data` gains the ea + cookies the
        CLIENT needs to destroy the objects (§6.4.2, ch. 8.4). Shared by
        unlink, remote unlink, and rename-over. Returns (removed_inode,
        cookies, dropped_buckets) for `_undo_drop`."""
        removed = self.inodes.pop(inode.fid)
        cookies = []
        buckets = []
        if inode.ftype == S_IFDIR:
            for bfid in inode.ea.get("buckets", []):
                bfid = tuple(bfid)
                if bfid[0] == self.inode_group:
                    b = self.inodes.pop(bfid, None)
                    if b is not None:
                        buckets.append(b)
                else:
                    bpeer = self._peer_for_group(bfid[0])
                    try:
                        brep = self._peer(bpeer).request(
                            "remote_unlink_inode",
                            {"fid": bfid, **self._cl_origin(req)})
                        if deps is not None:
                            deps[bpeer] = max(deps.get(bpeer, 0),
                                              brep.transno)
                    except (R.RpcError, R.TimeoutError_):
                        pass           # bucket survives for orphan cleanup
        if "lov" in inode.ea:
            for o in inode.ea["lov"]["objects"]:
                # lint: ok(emit-in-txn: cookies are cancelled by
                # _undo_drop, which every caller registers in its txn undo)
                rec = self.unlink_llog.add("unlink", {
                    "ost": o["ost"], "group": o["group"], "oid": o["oid"]})
                cookies.append(rec.cookie)
            data["ea"] = dict(inode.ea)
            data["cookies"] = cookies
        return removed, cookies, buckets

    def _undo_drop(self, removed: Inode, cookies: list, buckets: list):
        """Transaction rollback half of _drop_last_link (local state
        only: peer halves are the consistent cut's job)."""
        self.inodes[removed.fid] = removed
        self.unlink_llog.cancel(cookies)
        for b in buckets:
            self.inodes[b.fid] = b

    def _reint_unlink(self, r, req) -> R.Reply:
        parent = self._get(r["parent"])
        name = r["name"]
        self._revoke_client_locks(parent.fid, *parent.pfids,
                                  exclude=self._requester(req))
        fid = self._lookup_entry(parent, name)
        if fid is None:
            raise R.RpcError(-2, name)
        inode = self.inodes.get(fid)
        self._last_deps = None
        if inode is None:
            # inode lives on a peer MDS (§6.7.5 two-stage unlink)
            peer = self._peer_for_group(fid[0])
            rep = self._peer(peer).request(
                "remote_unlink_inode",
                {"fid": fid, **self._cl_origin(req)})
            self._dir_remove_raw(parent, name,
                                 exclude=self._requester(req))
            deps = dict(self._last_deps or {})
            deps[peer] = rep.transno
            remote_was_dir = rep.data.get("ftype") == S_IFDIR
            if remote_was_dir:
                # mirror the local path: the removed subdir's ".." link
                parent.nlink -= 1
            clrec = self._cl(req, cl_mod.CL_RMDIR if remote_was_dir
                             else cl_mod.CL_UNLINK, fid, pfid=parent.fid,
                             name=name, last=rep.data.get("last", False))

            def undo():
                # via _dir_insert: a split parent keeps entries in its
                # hash buckets, never in the master entries dict
                self._dir_insert(parent, name, fid)
                if remote_was_dir:
                    parent.nlink += 1
                self.changelog.retract(clrec)
            return R.Reply(data=rep.data,
                           transno=self.txn_meta(undo, deps))
        if inode.ftype == S_IFDIR and self._dir_nonempty(inode):
            raise R.RpcError(-39, "not empty")           # ENOTEMPTY
        was_dir = inode.ftype == S_IFDIR
        inode.nlink -= 2 if was_dir else 1
        self._dir_remove_raw(parent, name, exclude=self._requester(req))
        if was_dir:
            parent.nlink -= 1
        data = {"fid": fid}
        cookies = []
        removed = None
        dropped_buckets = []
        deps = dict(self._last_deps or {})
        if inode.nlink <= 0:
            removed, cookies, dropped_buckets = \
                self._drop_last_link(inode, data, req, deps)
        clrec = self._cl(req, cl_mod.CL_RMDIR if was_dir
                         else cl_mod.CL_UNLINK, fid, pfid=parent.fid,
                         name=name, last=removed is not None)

        def undo():
            if removed is not None:
                self._undo_drop(removed, cookies, dropped_buckets)
            removed_inode = self.inodes[fid]
            removed_inode.nlink += 2 if was_dir else 1
            # via _dir_insert: a split parent keeps entries in its hash
            # buckets, never in the master entries dict
            self._dir_insert(parent, name, fid)
            if was_dir:
                parent.nlink += 1
            self.changelog.retract(clrec)
        transno = self.txn_meta(undo, deps or None)
        self.ldlm.bump_version(("fid", *parent.fid))
        return R.Reply(data=data, transno=transno)

    def op_remote_unlink_inode(self, req: R.Request) -> R.Reply:
        fid = tuple(req.body["fid"])
        inode = self.inodes.get(fid)
        if inode is None:
            # idempotent replay (mirrors op_remote_mkdir): our inode half
            # already committed before the coordinator's crash rolled ITS
            # dirent half back — report the inode gone so the replayed
            # coordinator can finish that half. The ftype is unknowable
            # here, so a replayed cross-MDT rmdir leaves the parent's
            # nlink one high — the drift lfsck-class repair tolerates.
            self.sim.stats.count("mds.remote_unlink_replay")
            return R.Reply(data={"fid": fid, "ftype": None, "last": False})
        self._revoke_client_locks(*inode.pfids)   # cached nlink is stale
        was_dir = inode.ftype == S_IFDIR
        # authoritative ENOTEMPTY: the coordinator cannot see a remote
        # directory's entries, so ITS owner refuses here (before the
        # coordinator has mutated anything — this RPC goes first)
        if was_dir and self._dir_nonempty(inode):
            raise R.RpcError(-39, "not empty")
        # a directory loses both its name link and its own "." link —
        # decrementing by 1 left every cross-MDT-removed dir inode alive
        # forever (and published last=False for its final removal)
        inode.nlink -= 2 if was_dir else 1
        data = {"fid": fid, "ftype": inode.ftype}
        removed = None
        cookies = []
        dropped_buckets = []
        if inode.nlink <= 0:
            removed, cookies, dropped_buckets = \
                self._drop_last_link(inode, data, req)
        data["last"] = removed is not None
        # inode half of a cross-MDT unlink (§6.7.5 two-stage): nameless
        clrec = self._cl(req, cl_mod.CL_RMDIR if was_dir
                         else cl_mod.CL_UNLINK, fid, remote=True,
                         last=removed is not None)

        def undo():
            if removed is not None:
                self._undo_drop(removed, cookies, dropped_buckets)
            self.inodes[fid].nlink += 2 if was_dir else 1
            self.changelog.retract(clrec)
        return R.Reply(data=data, transno=self.txn_meta(undo))

    # --- rename / link / setattr
    def _reint_rename(self, r, req) -> R.Reply:
        """Rename, possibly across MDS nodes (§6.7.5 'the most interesting
        of all: three nodes'). The coordinator (chosen by the client per
        fid order, §6.7.1.4) performs remote lookup/remove/insert RPCs on
        peers and records the dependencies for the consistent cut. Local
        undo restores local state; cross-node atomicity is the cut's job."""
        src_fid, dst_fid = tuple(r["src"]), tuple(r["dst"])
        self._revoke_client_locks(
            src_fid, dst_fid,
            *getattr(self.inodes.get(src_fid), "pfids", ()),
            *getattr(self.inodes.get(dst_fid), "pfids", ()),
            exclude=self._requester(req))
        src = self.inodes.get(src_fid)
        dst = self.inodes.get(dst_fid)
        # --- read-only lookups first: the source entry and the entry the
        # rename will displace, wherever their parents live — ENOENT and
        # ENOTEMPTY (rename over a non-empty dir, as unlink refuses it)
        # are decided BEFORE anything mutates; rename onto itself is a
        # no-op victim-wise
        if src is not None:
            fid = self._lookup_entry(src, r["src_name"])
        else:
            speer = self._peer_for_group(src_fid[0])
            f = self._peer(speer).request(
                "bucket_lookup", {"bucket": src_fid,
                                  "name": r["src_name"]}).data.get("fid")
            fid = tuple(f) if f else None
        if fid is None:
            raise R.RpcError(-2, r["src_name"])
        if dst is not None:
            displaced = self._lookup_entry(dst, r["dst_name"])
        else:
            dpeer = self._peer_for_group(dst_fid[0])
            f = self._peer(dpeer).request(
                "bucket_lookup", {"bucket": dst_fid,
                                  "name": r["dst_name"]}).data.get("fid")
            displaced = tuple(f) if f else None
        if displaced is not None and tuple(displaced) == fid:
            displaced = None
        if displaced is not None:
            self._victim_empty_or_raise(tuple(displaced), r["dst_name"])
        deps = {}
        self._last_deps = None
        # --- source side: remove
        if src is not None:
            self._dir_remove_raw(src, r["src_name"],
                                 exclude=self._requester(req))
            if self._last_deps:
                deps.update(self._last_deps)
        else:
            rep = self._peer(speer).request(
                "bucket_remove", {"bucket": src_fid, "name": r["src_name"]})
            deps[speer] = rep.transno
        # --- destination side: insert
        self._last_deps = None
        if dst is not None:
            self._dir_insert(dst, r["dst_name"], fid,
                             exclude=self._requester(req))
            if self._last_deps:
                deps.update(self._last_deps)
        else:
            rep = self._peer(dpeer).request(
                "bucket_insert", {"bucket": dst_fid, "name": r["dst_name"],
                                  "fid": fid})
            deps[dpeer] = max(deps.get(dpeer, 0), rep.transno)
        inode = self.inodes.get(fid)
        if inode is not None:
            was_dir = inode.ftype == S_IFDIR
        elif fid[0] != self.inode_group:
            # the moved inode lives on a peer MDT: its type still decides
            # the parents' ".." nlink transfer below (peer failure here
            # must not abort — both namespace halves are applied already)
            try:
                was_dir = self._peer(self._peer_for_group(fid[0])).request(
                    "getattr", {"fid": fid}).data["attrs"]["type"] \
                    == S_IFDIR
            except (R.RpcError, R.TimeoutError_):
                was_dir = False
        else:
            was_dir = False
        # '..' transfer between the parents, reaching peer-owned ones
        # over remote_nlink_adjust (their halves join the consistent cut)
        transfer = was_dir and src_fid != dst_fid
        if transfer:
            if src is not None:
                src.nlink -= 1
            else:
                self._remote_nlink(src_fid, -1, deps)
            if dst is not None:
                dst.nlink += 1
            else:
                self._remote_nlink(dst_fid, +1, deps)
        # --- displaced victim: rename-over unlinks the old target (its
        # inode used to leak here with a dangling nlink, disagreeing
        # with any link-accounting consumer of the changelog)
        victim = self.inodes.get(tuple(displaced)) if displaced else None
        victim_was_dir = victim is not None and victim.ftype == S_IFDIR
        vremoved = None
        vcookies = []
        vbuckets = []
        vextra = {}
        data = {"fid": fid}
        v_dst_dec = False
        if displaced is not None and victim is None \
                and tuple(displaced)[0] != self.inode_group:
            # victim inode lives on a peer MDT: two-stage unlink of its
            # inode half (§6.7.5), like the remote branch of unlink.
            # (A displaced LOCAL-group fid with no inode is a dangling
            # entry — nothing to unlink, the insert already replaced it.)
            vpeer = self._peer_for_group(tuple(displaced)[0])
            try:
                vrep = self._peer(vpeer).request(
                    "remote_unlink_inode",
                    {"fid": displaced, **self._cl_origin(req)})
            except (R.RpcError, R.TimeoutError_) as e:
                # the namespace halves are already applied; aborting here
                # would leave a half-rename OUTSIDE any transaction. A
                # dangling entry (-2) has nothing to unlink; any other
                # peer failure leaves the victim inode alive on its MDT
                # for orphan cleanup — the rename itself stays atomic
                if not (isinstance(e, R.RpcError) and e.status == -2):
                    self.sim.stats.count("mds.rename_victim_skipped")
                vrep = None
            if vrep is not None:
                deps[vpeer] = max(deps.get(vpeer, 0), vrep.transno)
                for k in ("ea", "cookies"):
                    if k in vrep.data:
                        data[k] = vrep.data[k]
                if vrep.data.get("ftype") == S_IFDIR \
                        and vrep.data.get("last"):
                    # the victim dir's ".." link leaves the dst parent
                    if dst is not None:
                        dst.nlink -= 1
                        v_dst_dec = True
                    else:
                        self._remote_nlink(dst_fid, -1, deps)
                vextra = {"victim": tuple(displaced),
                          "victim_last": vrep.data.get("last", False)}
        elif victim is not None:
            victim.nlink -= 2 if victim_was_dir else 1
            if victim.nlink <= 0:
                vremoved, vcookies, vbuckets = \
                    self._drop_last_link(victim, data, req, deps)
                if victim_was_dir:
                    if dst is not None:
                        dst.nlink -= 1         # its ".." link
                    else:
                        self._remote_nlink(dst_fid, -1, deps)
            vextra = {"victim": victim.fid,
                      "victim_last": vremoved is not None}
        clrec = self._cl(req, cl_mod.CL_RENAME, fid, pfid=dst_fid,
                         name=r["dst_name"], spfid=src_fid,
                         sname=r["src_name"], **vextra)

        def undo():
            if v_dst_dec:
                dst.nlink += 1
            if victim is not None:
                if vremoved is not None:
                    self._undo_drop(vremoved, vcookies, vbuckets)
                    if victim_was_dir and dst is not None:
                        dst.nlink += 1
                self.inodes[victim.fid].nlink += 2 if victim_was_dir else 1
            if dst is not None:
                self._dir_remove_raw(dst, r["dst_name"])
                if displaced is not None:
                    # via _dir_insert: a split dst keeps its entries in
                    # hash buckets, never in the master entries dict
                    self._dir_insert(dst, r["dst_name"], displaced)
            if src is not None:
                self._dir_insert(src, r["src_name"], fid)
            if transfer:
                if src is not None:
                    src.nlink += 1
                if dst is not None:
                    dst.nlink -= 1
            self.changelog.retract(clrec)
        transno = self.txn_meta(undo, deps or None)
        for pf in {src_fid, dst_fid}:
            self.ldlm.bump_version(("fid", *pf))
        return R.Reply(data=data, transno=transno)

    def _reint_link(self, r, req) -> R.Reply:
        fid = tuple(r["fid"])
        parent = self._get(r["parent"])
        self._revoke_client_locks(parent.fid, *parent.pfids,
                                  exclude=self._requester(req))
        # EEXIST check BEFORE any nlink bump: the remote_link RPC commits
        # on the peer in its own transaction, so raising after it used to
        # leak a permanent +1 on the remote inode's nlink
        if self._lookup_entry(parent, r["name"]) is not None:
            raise R.RpcError(-17, r["name"])
        inode = self.inodes.get(fid)
        self._last_deps = None
        deps = {}
        if inode is None:
            peer = self._peer_for_group(fid[0])
            rep = self._peer(peer).request("remote_link", {"fid": fid})
            deps[peer] = rep.transno
        else:
            inode.nlink += 1
        self._dir_insert(parent, r["name"], fid,
                         exclude=self._requester(req))
        if self._last_deps:
            deps.update(self._last_deps)
        clrec = self._cl(req, cl_mod.CL_LINK, fid, pfid=parent.fid,
                         name=r["name"])

        def undo():
            self._dir_remove_raw(parent, r["name"])
            if inode is not None:
                inode.nlink -= 1
            self.changelog.retract(clrec)
        return R.Reply(data={"fid": fid},
                       transno=self.txn_meta(undo, deps or None))

    def op_remote_link(self, req: R.Request) -> R.Reply:
        inode = self._get(req.body["fid"])
        self._revoke_client_locks(*inode.pfids)   # cached nlink is stale
        inode.nlink += 1

        def undo():
            inode.nlink -= 1
        return R.Reply(transno=self.txn_meta(undo))

    def _reint_setattr(self, r, req) -> R.Reply:
        inode = self._get(r["fid"])
        # attribute update: clients may cache this inode's attrs under
        # the PR locks of the directories it is linked in (readdir-plus
        # / statahead) — revoke them so no stale attr is ever served
        # (the requester drops its own copy locally)
        self._revoke_client_locks(*inode.pfids,
                                  exclude=self._requester(req))
        self._revoke_remote_pfids(inode, req)
        old = (dict(inode.ea), inode.mode, inode.uid, inode.gid,
               inode.mtime, inode.size)
        a = r.get("attrs", {})
        if "ea" in r:
            inode.ea.update(r["ea"])
        inode.mode = a.get("mode", inode.mode)
        inode.uid = a.get("uid", inode.uid)
        inode.gid = a.get("gid", inode.gid)
        inode.mtime = a.get("mtime", inode.mtime)
        if "size" in a:
            inode.size = a["size"]
        clrec = self._cl(req, cl_mod.CL_SETATTR, inode.fid, attrs=dict(a),
                         ea_keys=sorted(r["ea"]) if r.get("ea") else [])

        def undo():
            (inode.ea, inode.mode, inode.uid, inode.gid, inode.mtime,
             inode.size) = ({**old[0]}, *old[1:])
            self.changelog.retract(clrec)
        return R.Reply(data={"attrs": inode.attrs()},
                       transno=self.txn_meta(undo))

    # ---------------------------------------------------- directory split
    def _split_dir(self, parent: Inode):
        """§6.7.3: fan a large directory out into hash buckets on peer
        MDSes (and locally)."""
        peers = sorted(self.peer_nids)
        ways = min(self.SPLIT_WAYS, len(peers) + 1)
        buckets = []
        for i in range(ways):
            if i == 0:
                bfid = self.new_fid()
                self.inodes[bfid] = Inode(bfid, S_IFDIR, nlink=2)
            else:
                peer = peers[(i - 1) % len(peers)]
                rep = self._peer(peer).request("remote_mkdir", {},
                                               fixup=_pin_remote_fid)
                bfid = tuple(rep.data["fid"])
            buckets.append(bfid)
        entries = dict(parent.entries)
        parent.entries.clear()
        parent.ea["buckets"] = buckets
        for name, fid in entries.items():
            bfid = tuple(buckets[fhash(name, ways)])
            if bfid[0] == self.inode_group:
                self._get(bfid).entries[name] = fid
            else:
                peer = self._peer_for_group(bfid[0])
                self._peer(peer).request(
                    "bucket_insert", {"bucket": bfid, "name": name,
                                      "fid": fid})
        self.sim.stats.count("mds.dir_split")

    def op_bucket_insert(self, req: R.Request) -> R.Reply:
        bucket = self._get(req.body["bucket"])
        name = req.body["name"]
        fid = tuple(req.body["fid"])
        bucket.entries[name] = fid
        child = self.inodes.get(fid)
        if child is not None:
            child.pfids.add(bucket.fid)
        # readdir-plus pages of this bucket were served under ITS PR
        # lock; the originating client (forwarded by the coordinator)
        # fixes its own caches, like every other requester
        self._revoke_client_locks(bucket.fid,
                                  exclude=req.body.get("exclude"))

        def undo():
            bucket.entries.pop(name, None)
        return R.Reply(transno=self.txn_meta(undo))

    def op_bucket_lookup(self, req: R.Request) -> R.Reply:
        bucket = self._get(req.body["bucket"])
        return R.Reply(data={"fid": bucket.entries.get(req.body["name"])})

    def op_bucket_remove(self, req: R.Request) -> R.Reply:
        bucket = self._get(req.body["bucket"])
        name = req.body["name"]
        fid = bucket.entries.pop(name, None)
        self._revoke_client_locks(bucket.fid,
                                  exclude=req.body.get("exclude"))

        def undo():
            if fid is not None:
                bucket.entries[name] = fid
        return R.Reply(data={"fid": fid}, transno=self.txn_meta(undo))

    # -------------------------------------------------- llog / recovery
    def op_llog_cancel(self, req: R.Request) -> R.Reply:
        n = self.unlink_llog.cancel(req.body["cookies"])
        return R.Reply(data={"cancelled": n})

    def process_unlink_llog(self, ost_imports: dict[str, R.Import]) -> int:
        """After MDS recovery: re-ship destroys for uncancelled unlink
        records (§6.7.5). Idempotent on the OST."""
        def ship(rec: llog_mod.LlogRecord) -> bool:
            imp = ost_imports.get(rec.payload["ost"])
            if imp is None:
                return False
            try:
                imp.request("destroy", {"group": rec.payload["group"],
                                        "oid": rec.payload["oid"],
                                        "cookie": rec.cookie})
                return True
            except (R.RpcError, R.TimeoutError_):
                return False
        return self.unlink_llog.process(ship)

    def orphan_cleanup(self, lov_targets: dict[str, R.Import],
                       group: int) -> dict:
        """§6.7.5 second half: destroy OST objects no file references
        (client died between object create and EA setattr)."""
        keep: dict[str, set] = {u: set() for u in lov_targets}
        for inode in self.inodes.values():
            lsm = inode.ea.get("lov")
            if lsm:
                for o in lsm["objects"]:
                    if o["ost"] in keep and o["group"] == group:
                        keep[o["ost"]].add(o["oid"])
        out = {}
        for uuid, imp in lov_targets.items():
            objs = imp.request("list_objects", {"group": group}).data
            doomed = [o for o in objs if o not in keep[uuid]]
            for oid in doomed:
                imp.request("destroy", {"group": group, "oid": oid})
            out[uuid] = doomed
        return out

    # ------------------------------------------- consistent cut support
    def op_dep_records(self, req: R.Request) -> R.Reply:
        return R.Reply(data={
            "committed": self.committed_transno,
            "deps": [(t, d) for t, d in self.dep_log]})

    def op_rollback_to(self, req: R.Request) -> R.Reply:
        """Undo all retained transactions with transno > cut (§6.7.6.3)."""
        cut = req.body["transno"]
        undone = 0
        for transno, undo in sorted(self.undo_history, reverse=True,
                                    key=lambda t: t[0]):
            if transno > cut:
                undo()
                undone += 1
        self.undo_history = [(t, u) for t, u in self.undo_history
                             if t <= cut]
        self.dep_log = [(t, d) for t, d in self.dep_log if t <= cut]
        self.transno = min(self.transno, cut)
        self.committed_transno = min(self.committed_transno, cut)
        self.cluster_cut = min(self.cluster_cut, cut)
        self.vbr_prune(cut)               # version history follows the cut
        self._cut_checked_at = None       # the world changed: re-derive
        return R.Reply(data={"undone": undone})

    def op_prune_history(self, req: R.Request) -> R.Reply:
        cut = req.body["transno"]
        self.undo_history = [(t, u) for t, u in self.undo_history if t > cut]
        self.dep_log = [(t, d) for t, d in self.dep_log if t > cut]
        # the leader proved everything <= cut cluster-committed (§6.7.6.3
        # steady state): changelog serving can trust it without re-deriving
        # — the push also refreshes the derivation cache
        self.cluster_cut = max(self.cluster_cut, cut)
        self._cut_checked_at = self.sim.now
        return R.Reply()
