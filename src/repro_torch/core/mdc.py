"""Metadata client (MDC), clustered-MDS router (LMV), and the client
metadata write-back cache (paper §6.7.1.1, ch. 17, ch. 26).

The LMV is deliberately thin (§6.7.1.1: "the client part of the
implementation is very trivial"): it picks the MDC by
  (1) the inode group of the fid in the request,
  (2) the name hash + bucket EA for split directories,
  (3) fid order for rename coordination (§6.7.1.4).

The write-back cache (ch. 17) holds a subtree lock + preallocated fids;
updates apply to a local shadow namespace and are recorded as reintegration
records, flushed as batched `reint_batch` RPCs — in the background on
batch-size/age/pressure thresholds, and as a barrier on fsync/close/
release or a blocking AST on the subtree lock.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.core import dlm as dlm_mod
from repro_torch.core import fail as fail_mod
from repro_torch.core import mds as mds_mod
from repro_torch.core import ptlrpc as R


class Mdc:
    """Client stub for ONE MDS target."""

    def __init__(self, rpc: R.RpcClient, target_uuid: str, nids: list[str]):
        self.rpc = rpc
        self.sim = rpc.sim
        self.uuid = target_uuid
        self.imp = rpc.import_target(target_uuid, nids, "mds")
        self.locks = dlm_mod.LockClient(rpc, self.imp)

    # -------------------------------------------------------- intent ops
    def enqueue_intent(self, res_fid, mode: str, intent: dict):
        """mdc_enqueue (§6.2.2): lock + operation in one RPC."""
        def fixup(req, rep):
            d = (rep.data or {}).get("intent") or {}
            attrs = d.get("attrs")
            if d.get("created") and attrs:
                # pin the assigned fid so replay recreates the same inode
                req.body["intent"]["fid"] = tuple(attrs["fid"])
        lk, data, lvb = self.locks.enqueue(
            ("fid", *tuple(res_fid)), mode, None, intent=intent,
            use_cache=False, fixup=fixup)
        return lk, (data or {})

    def getattr_lock(self, parent_fid, name: str, want_ea: bool = False):
        return self.enqueue_intent(
            parent_fid, "PR", {"op": "lookup", "parent": tuple(parent_fid),
                               "name": name, "want_ea": want_ea})

    def open(self, parent_fid, name: str, flags: str = "r",
             mode: int = 0o644):
        return self.enqueue_intent(
            parent_fid, "PR", {"op": "open", "parent": tuple(parent_fid),
                               "name": name, "flags": flags, "mode": mode})

    def readdir_plus(self, fid, page_size: int, after: str | None = None,
                     want_ea: bool = True):
        """ONE readdir-plus page (entries + per-entry attrs/EA) under
        the directory's PR lock. `after` is a NAME cursor (the
        last name of the previous page) so pagination stays stable under
        concurrent creates/unlinks. Returns (lock, data)."""
        return self.enqueue_intent(
            fid, "PR", {"op": "readdir", "fid": tuple(fid),
                        "page_size": page_size, "after": after,
                        "want_ea": want_ea})

    # --------------------------------------------------------- plain ops
    def getattr(self, fid, want_ea: bool = False) -> dict:
        return self.imp.request("getattr", {"fid": tuple(fid),
                                            "want_ea": want_ea}).data

    def getattr_bulk(self, fids: list, want_ea: bool = False) -> list:
        """Batched getattr: ONE RPC, attrs (+EA) per fid (None for
        unknown fids) — the statahead / readdir-plus merge primitive."""
        return self.imp.request(
            "getattr_bulk", {"fids": [tuple(f) for f in fids],
                             "want_ea": want_ea}).data["attrs"]

    def readdir(self, fid) -> dict:
        return self.imp.request("readdir", {"fid": tuple(fid)}).data

    def reint(self, rec: dict) -> R.Reply:
        def fixup(req, rep):
            # pin the server-assigned fid so REPLAY recreates the same
            # inode (even when it was created on a peer MDS)
            if rec["type"] == "create" and (rep.data or {}).get("fid"):
                req.body["rec"]["fid"] = tuple(rep.data["fid"])
        return self.imp.request("reint", {"rec": rec}, fixup=fixup)

    def reint_batch(self, records: list) -> R.Reply:
        def fixup(req, rep):
            # pin server-assigned fids per record so REPLAY re-creates
            # the same inodes (WBC records normally carry preallocated
            # fids already — this covers records without one)
            results = (rep.data or {}).get("results") or []
            for r, res in zip(req.body["records"], results):
                d = res.get("data") or {}
                if r.get("type") == "create" and not r.get("fid") \
                        and d.get("fid"):
                    r["fid"] = tuple(d["fid"])
        return self.imp.request("reint_batch", {"records": records},
                                fixup=fixup)

    def close(self, handle: int, size=None, mtime=None,
              fid=None) -> R.Reply:
        return self.imp.request("close", {"handle": handle, "size": size,
                                          "mtime": mtime,
                                          "fid": tuple(fid) if fid else None})

    def statfs(self) -> dict:
        return self.imp.request("statfs", {}).data

    def prealloc_fids(self, count: int = 64) -> list:
        return [tuple(f) for f in
                self.imp.request("prealloc_fids",
                                 {"count": count}).data["fids"]]

    # -------------------------------------------------- changelog consumer
    def changelog_register(self) -> str:
        """Register as a changelog consumer; returns the consumer id."""
        return self.imp.request("changelog_register", {}).data["id"]

    def changelog_deregister(self, user: str):
        self.imp.request("changelog_deregister", {"id": user})

    def changelog_read(self, user: str, since_idx: int | None = None,
                       count: int = 0) -> list[dict]:
        """Fetch retained records above `since_idx` (default: the
        consumer's bookmark). Does NOT advance the bookmark — that is
        `changelog_clear`'s job, after the consumer persisted them."""
        return self.imp.request(
            "changelog_read", {"id": user, "since_idx": since_idx,
                               "count": count}).data["records"]

    def changelog_clear(self, user: str, up_to: int) -> dict:
        """Acknowledge records <= up_to; the MDT purges only past the
        minimum bookmark across all registered consumers."""
        return self.imp.request(
            "changelog_clear", {"id": user, "up_to": up_to}).data


class Lmv:
    """Logical Metadata Volume: routes ops across the MDS cluster
    (§6.7.1.1). mdcs[i] serves inode group i."""

    def __init__(self, mdcs: list[Mdc]):
        self.mdcs = mdcs
        self.sim = mdcs[0].sim

    def mdc_for_fid(self, fid) -> Mdc:
        return self.mdcs[tuple(fid)[0] % len(self.mdcs)]

    def mdc_for_rename(self, src_fid, dst_fid) -> Mdc:
        """§6.7.1.4: coordinate at the highest-order resource so the lock
        ordering sequence starts correctly."""
        first = min(tuple(src_fid), tuple(dst_fid))
        return self.mdc_for_fid(first)

    # ------------------------------------------------------- routed ops
    def getattr(self, fid, want_ea=False):
        return self.mdc_for_fid(fid).getattr(fid, want_ea)

    def getattr_lock(self, parent_fid, name, want_ea=False):
        mdc = self.mdc_for_fid(parent_fid)
        lk, data = mdc.getattr_lock(parent_fid, name, want_ea)
        if data.get("redirect"):
            # split directory: retry at the bucket's MDS (§6.7.3)
            bfid = tuple(data["redirect"])
            mdc = self.mdc_for_fid(bfid)
            lk, data = mdc.enqueue_intent(
                bfid, "PR", {"op": "lookup", "parent": bfid,
                             "name": name, "want_ea": want_ea})
        data["_granted_by"] = self.mdcs.index(mdc)
        if data.get("remote") and data.get("fid"):
            # entry's inode lives on a peer MDS (directly, or behind the
            # bucket redirect): 2nd RPC for attributes (the §6.7.3
            # 'worst case 3 RPCs' path). The lock is on the lookup-side
            # namespace, so these attrs are NOT covered by it — flag
            # them so the client attr cache skips them.
            fid = tuple(data["fid"])
            d2 = self.mdc_for_fid(fid).getattr(fid, want_ea)
            d2["status"] = 0
            d2["_remote"] = True
            d2["_granted_by"] = self.mdcs.index(mdc)
            return lk, d2
        return lk, data

    def open(self, parent_fid, name, flags="r", mode=0o644):
        lk, data = self.mdc_for_fid(parent_fid).open(parent_fid, name,
                                                     flags, mode)
        if data.get("remote") and data.get("fid"):
            # the entry's inode lives on a peer MDT (cross-MDT rename
            # residue): re-issue the open BY FID at the owning MDT —
            # the same 2-RPC worst case as the lookup redirect (§6.7.3)
            fid = tuple(data["fid"])
            return self.mdc_for_fid(fid).enqueue_intent(
                fid, "PR", {"op": "open", "by_fid": True, "fid": fid,
                            "flags": flags, "mode": mode})
        return lk, data

    def readdir_plus(self, fid, page_size: int, want_ea: bool = True):
        """readdir-plus page generator: yields (mdc, lock,
        entries) pages — entries = {name: {"fid", "attrs"?, "ea"?,
        "remote"?}} — walking the master directory and then every
        split-dir hash bucket AT ITS OWN MDS (one page-RPC per MDT, each
        under that MDT's dir/bucket PR lock). Entries whose inode a peer
        MDT owns are batch-resolved with ONE getattr_bulk per owning MDT
        per page (their attrs stay flagged `remote`: no covering lock)."""
        todo = [tuple(fid)]
        master = True
        while todo:
            dfid = todo.pop(0)
            mdc = self.mdc_for_fid(dfid)
            after = None
            while True:
                lk, data = mdc.readdir_plus(dfid, page_size, after,
                                            want_ea)
                st = data.get("status", 0)
                if st:
                    raise R.RpcError(st, str(dfid))
                if master and data.get("buckets"):
                    todo.extend(tuple(b) for b in data["buckets"])
                page = data["entries"]
                remote: dict = {}
                for name, e in page.items():
                    if e.get("remote"):
                        remote.setdefault(self.mdc_for_fid(e["fid"]),
                                          []).append(name)
                for rmdc, names in remote.items():
                    outs = rmdc.getattr_bulk(
                        [page[n]["fid"] for n in names], want_ea)
                    for n, a in zip(names, outs):
                        if a:
                            page[n].update(a)
                yield mdc, lk, page
                if data.get("next") is None:
                    break
                after = data["next"]
            master = False

    def readdir(self, fid):
        """Client-side bucket iteration for split directories (§6.7.3)."""
        out = self.mdc_for_fid(fid).readdir(fid)
        if out.get("buckets"):
            entries = dict(out["entries"])
            for bfid in out["buckets"]:
                bfid = tuple(bfid)
                b = self.mdc_for_fid(bfid).readdir(bfid)
                entries.update(b["entries"])
            out = dict(out, entries=entries)
        return out

    def reint(self, rec: dict):
        key = {"create": "parent", "unlink": "parent", "link": "parent",
               "setattr": "fid"}.get(rec["type"])
        if rec["type"] == "rename":
            mdc = self.mdc_for_rename(rec["src"], rec["dst"])
        else:
            mdc = self.mdc_for_fid(rec[key])
        return mdc.reint(rec)

    def close(self, fid, handle, size=None, mtime=None):
        return self.mdc_for_fid(fid).close(handle, size, mtime, fid=fid)

    def statfs(self):
        return [m.statfs() for m in self.mdcs]


# -------------------------------------------------------------------- WBC

_GONE = object()          # shadow negative entry: name is known absent


class WbcCache:
    """Metadata write-back cache for one directory subtree (ch. 17).

    Holds an EX subtree lock + preallocated fids; namespace updates below
    the root apply to a local shadow and append reintegration records
    (the InterMezzo property, §2.4), shipped later as `reint_batch` RPCs.
    Flush triggers: `release()`, a blocking AST on the subtree lock
    (§17.2), an fsync/close barrier from the VFS layer — and, when the
    thresholds are armed, background flushes on batch size (`batch`
    records ship as one RPC, the tail stays dirty), total dirty records
    (`max_dirty`: cache pressure, everything ships) or age of the oldest
    record (`max_age`). A multi-batch flush keeps up to `max_rpcs`
    batches in flight (§17.1 reintegration pipelining).

    The shadow keeps a COMPLETE listing for every directory it owns —
    shadow-born directories by construction, pre-existing ones seeded
    with one readdir on first touch — so lookups, readdirs and negative
    lookups (`GONE`) under the subtree cost zero RPCs while the EX lock
    holds them coherent.
    """

    GONE = _GONE

    def __init__(self, lmv: Lmv, root_fid: tuple, *, batch: int = 0,
                 max_dirty: int = 0, max_age: float = 0.0,
                 max_rpcs: int = 8):
        self.lmv = lmv
        self.root_fid = tuple(root_fid)
        self.mdc = lmv.mdc_for_fid(root_fid)
        self.sim = lmv.sim
        self.batch = batch             # background flush unit (0 = off)
        self.max_dirty = max_dirty     # dirty-record cap (0 = off)
        self.max_age = max_age         # oldest-record age cap (0 = off)
        self.max_rpcs = max(1, max_rpcs)
        self.records: list[dict] = []
        self.fids: list[tuple] = []
        self.shadow: dict[tuple, dict] = {}    # dir fid -> {name: fid}
        self.shadow_attrs: dict[tuple, dict] = {}   # shadow-born inodes
        self.complete: set[tuple] = set()      # dirs with full listings
        self.gone: set[tuple] = set()          # (pfid, name) known absent
        self.known: set[tuple] = set()         # fids inside the subtree
        self.lock: dlm_mod.Lock | None = None
        self.active = False
        self.first_dirty_t: float | None = None
        # fsio sinks: destroy_cb consumes unlink reply data (ea+cookies)
        # so flushed unlinks still destroy their OST objects
        self.destroy_cb = None
        self._orig_cb: Any = None
        self._cb_installed = False
        self._revoke_cb = None

    # ------------------------------------------------------------ grant
    def acquire(self) -> bool:
        lk, data = self.mdc.enqueue_intent(
            self.root_fid, "EX", {"op": "wbc", "fid": self.root_fid})
        if not (data or {}).get("wbc_granted"):
            self.sim.stats.count("wbc.denied")
            return False
        self.lock = lk
        self.active = True
        self.known.add(self.root_fid)
        self.fids = self.mdc.prealloc_fids(128)
        self.sim.stats.count("wbc.granted")
        # flush when the subtree lock is revoked; remember the ORIGINAL
        # callback so release() can restore it (a wrapper per
        # enable/disable cycle used to pile up here, each flushing a
        # dead cache)
        self._orig_cb = self.mdc.locks.flush_cb
        self._cb_installed = True

        def cb(lock):
            if self.lock is not None and lock.handle == self.lock.handle:
                self.flush()
            elif self._orig_cb:
                self._orig_cb(lock)
        self.mdc.locks.flush_cb = cb
        # the lock leaving the cache for ANY reason (AST, eviction)
        # deactivates the cache: the shadow is only coherent under it
        def rcb(lock):
            if self.lock is not None and lock.handle == self.lock.handle:
                self._deactivate(lost=True)
        self._revoke_cb = rcb
        self.mdc.locks.revoke_cbs.append(rcb)
        if lk is not None:
            lk.dirty = True
        return True

    def _deactivate(self, lost: bool = False):
        """The subtree lock is gone (or being released): the shadow is no
        longer coherent. With `lost`, pending records die with the lock —
        eviction semantics: exactly the unflushed tail is lost."""
        if lost and self.records:
            self.sim.stats.count("wbc.lost_records", len(self.records))
            self.records = []
        self.first_dirty_t = None
        self.active = False
        self.lock = None
        self.shadow.clear()
        self.shadow_attrs.clear()
        self.complete.clear()
        self.gone.clear()
        self.known.clear()

    def _fid(self) -> tuple:
        if not self.fids:
            self.fids = self.mdc.prealloc_fids(128)
        return self.fids.pop(0)

    def in_subtree(self, fid: tuple) -> bool:
        return tuple(fid) == self.root_fid or tuple(fid) in self.known

    # ----------------------------------------------------- shadow reads
    def _ensure_listing(self, pfid: tuple) -> bool:
        """Make the shadow's listing of `pfid` complete. Shadow-born dirs
        are complete by construction; a pre-existing dir is seeded with
        ONE readdir under the subtree EX lock (amortised over every later
        lookup/readdir below it). Returns False when the shadow cannot
        own the dir (split into buckets, outside the subtree)."""
        p = tuple(pfid)
        if p in self.complete:
            return True
        if p in self.shadow_attrs:                 # shadow-born
            self.shadow.setdefault(p, {})
            self.complete.add(p)
            return True
        if not self.in_subtree(p):
            return False
        try:
            out = self.lmv.readdir(p)
        except R.RpcError:
            return False
        if out.get("buckets"):
            return False                           # split dir: too big
        listing = self.shadow.setdefault(p, {})
        for name, fid in out["entries"].items():
            if (p, name) in self.gone:
                continue                           # locally unlinked
            listing.setdefault(name, tuple(fid))   # local updates win
            self.known.add(tuple(fid))
        self.gone = {g for g in self.gone if g[0] != p}
        self.complete.add(p)
        self.sim.stats.count("wbc.seed")
        return True

    def lookup(self, parent_fid, name):
        """Shadow lookup: a fid, GONE (known absent — the shadow's
        negative entry), or None (the shadow does not know)."""
        p = tuple(parent_fid)
        if (p, name) in self.gone:
            return _GONE
        ent = self.shadow.get(p, {}).get(name)
        if ent is not None:
            return ent
        return _GONE if p in self.complete else None

    def child(self, parent_fid, name):
        """Resolve one component under the WBC. Returns (handled, fid):
        handled=False falls through to the MDS; handled=True with
        fid=None is an authoritative ENOENT answered locally."""
        p = tuple(parent_fid)
        if not self.active or not self.in_subtree(p):
            return False, None
        hit = self.lookup(p, name)
        if hit is _GONE:
            return True, None
        if hit is not None:
            return True, hit
        if not self._ensure_listing(p):
            return False, None
        hit = self.lookup(p, name)
        return True, None if hit is _GONE else hit

    def listing(self, pfid) -> dict | None:
        """Complete {name: fid} view of a shadow-owned directory."""
        if not self._ensure_listing(pfid):
            return None
        return dict(self.shadow.get(tuple(pfid), {}))

    def attrs(self, fid) -> dict | None:
        return self.shadow_attrs.get(tuple(fid))

    # --------------------------------------------------------- local ops
    def create(self, parent_fid, name, ftype=mds_mod.S_IFREG,
               mode=0o644, ea=None, target="") -> tuple:
        """Local create: zero RPCs (the InterMezzo property, §2.4)."""
        fid = self._fid()
        p = tuple(parent_fid)
        rec = {"type": "create", "parent": p, "name": name,
               "fid": fid, "ftype": ftype, "mode": mode, "remote_ok": False}
        if ea:
            rec["ea"] = ea
        if target:
            rec["target"] = target
        self.records.append(rec)
        self.shadow.setdefault(p, {})[name] = fid
        self.gone.discard((p, name))
        self.shadow_attrs[fid] = {"fid": fid, "type": ftype, "mode": mode,
                                  "nlink": 2 if ftype == mds_mod.S_IFDIR
                                  else 1,
                                  "mtime": self.sim.now, "size": 0,
                                  "mtime_on_ost": False}
        if ea:
            self.shadow_attrs[fid]["ea"] = dict(ea)
        if target:
            self.shadow_attrs[fid]["symlink"] = target
        self.known.add(fid)
        if ftype == mds_mod.S_IFDIR:
            # born in the cache: its listing is complete by construction
            self.shadow.setdefault(fid, {})
            self.complete.add(fid)
        self._note_dirty()
        return fid

    def setattr(self, fid, attrs=None, ea=None):
        rec = {"type": "setattr", "fid": tuple(fid), "attrs": attrs or {}}
        if ea:
            rec["ea"] = ea
        self.records.append(rec)
        sa = self.shadow_attrs.get(tuple(fid))
        if sa is not None:
            sa.update(attrs or {})
            if ea:
                sa.setdefault("ea", {}).update(ea)
        self._note_dirty()

    def unlink(self, parent_fid, name):
        p = tuple(parent_fid)
        self.records.append({"type": "unlink", "parent": p, "name": name})
        fid = self.shadow.get(p, {}).pop(name, None)
        if fid is not None:
            self.shadow_attrs.pop(tuple(fid), None)
            self.shadow.pop(tuple(fid), None)
            self.complete.discard(tuple(fid))
            self.known.discard(tuple(fid))
        if p not in self.complete:
            # incomplete listing: remember the negative entry explicitly
            self.gone.add((p, name))
        self._note_dirty()

    def forget(self, pfid):
        """Drop the shadow's claim on one directory (a synchronous op
        slipped past the shadow): the next access re-seeds it."""
        p = tuple(pfid)
        self.shadow.pop(p, None)
        self.complete.discard(p)
        self.gone = {g for g in self.gone if g[0] != p}

    # -------------------------------------------------------------- flush
    def _note_dirty(self):
        self.sim.stats.count("wbc.local_update")
        if self.first_dirty_t is None:
            self.first_dirty_t = self.sim.now
        if self.max_dirty and len(self.records) >= self.max_dirty:
            self.sim.stats.count("wbc.flush_pressure")
            self.flush()
        elif self.batch and len(self.records) >= self.batch:
            self.sim.stats.count("wbc.flush_batch")
            self._flush_n(self.batch)
        elif self.max_age and self.sim.now - self.first_dirty_t \
                >= self.max_age:
            self.sim.stats.count("wbc.flush_age")
            self.flush()

    def flush(self) -> int:
        """Barrier: reintegrate EVERY pending record (fsync/close/
        release/AST all funnel here)."""
        return self._flush_n(len(self.records))

    def _flush_n(self, n: int) -> int:
        """Ship the oldest `n` records, split into `batch`-sized
        reint_batch RPCs, up to `max_rpcs` in flight per wave. Records
        apply in order: batches within a wave arrive (and are serviced)
        in issue order at the one owning MDS."""
        if n <= 0 or not self.records:
            return 0
        recs, self.records = self.records[:n], self.records[n:]
        if not self.records:
            self.first_dirty_t = None
        act = fail_mod.state.check("mdc.wbc_flush")
        if act in ("drop", "crash"):
            # client-side site (crash degrades to drop, like osc.flush):
            # the first batch RPC is lost on the wire; the import
            # recovers by timeout -> reconnect -> resend
            self.sim.faults.drop_next[self.mdc.imp.active_nid] += 1
        bs = self.batch or len(recs)
        batches = [recs[i:i + bs] for i in range(0, len(recs), bs)]
        for i in range(0, len(batches), self.max_rpcs):
            wave = batches[i:i + self.max_rpcs]
            if len(wave) == 1:
                reps = [self.mdc.reint_batch(wave[0])]
            else:
                reps = self.sim.parallel(
                    [(lambda b=b: self.mdc.reint_batch(b))
                     for b in wave])
            for b, rep in zip(wave, reps):
                self._flush_done(b, rep)
        return len(recs)

    def _flush_done(self, batch: list, rep: R.Reply):
        st = self.sim.stats
        st.count("wbc.flush")
        st.count("wbc.flushed_records", len(batch))
        size = len(batch)
        st.count(f"wbc.batch_hist.{1 << max(0, size - 1).bit_length()}")
        for r, res in zip(batch, (rep.data or {}).get("results") or []):
            if res.get("status"):
                st.count("wbc.reint_errors")
                continue
            d = res.get("data") or {}
            if r["type"] == "unlink" and d.get("ea") and self.destroy_cb:
                # the flushed unlink dropped the last link: destroy the
                # OST objects with the returned EA + llog cookies
                self.destroy_cb(d)

    def release(self):
        self.flush()
        if self.lock is not None:
            self.lock.dirty = False
            self.mdc.locks.cancel(self.lock)   # fires _deactivate via rcb
        # restore the pre-acquire callbacks (no wrapper stacking)
        if self._cb_installed:
            self.mdc.locks.flush_cb = self._orig_cb
            self._cb_installed = False
            self._orig_cb = None
        if self._revoke_cb is not None:
            try:
                self.mdc.locks.revoke_cbs.remove(self._revoke_cb)
            except ValueError:
                pass
            self._revoke_cb = None
        self._deactivate()
