"""Object Storage Client (paper §2.2, ch. 25) with write-back page cache.

The OSC exposes the same OBD API as a direct device but ships each call to
an OST. It owns:
  * a LockClient on the OST's DLM namespace (extent locks; reads take PR,
    writes PW; the server grows extents per §7.5 so sequential I/O takes
    ONE lock RPC per object, which our benchmarks measure);
  * a write-back cache of dirty extents flushed on lock revocation, grant
    exhaustion, or explicit sync (ch. 28.5);
  * the client half of the grant protocol (ch. 10.12);
  * the vectored BRW engine (§4.5.6): adjacent/overlapping dirty extents
    are coalesced, flushes ship *niobuf vectors* (many extents per
    OST_WRITE RPC) bounded by `max_pages_per_rpc`, and RPC dispatch is
    flow-controlled by `max_rpcs_in_flight`;
  * referral handling: reads bounced to a collaborative cache follow the
    referral to the caching OST (§5.5);
  * a CLEAN read cache (§7.4-§7.7): extents fetched by reads (and dirty
    extents promoted at flush) stay cached, LRU-bounded by
    `max_cached_mb`, and are served with ZERO RPCs for as long as a
    cached PR/PW lock covers them. Lock revocation (blocking AST),
    cancel, and eviction invalidate the covered pages — cached data is
    valid exactly while the lock protocol says it is.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

from repro_torch.core import dlm as dlm_mod
from repro_torch.core import fail as fail_mod
from repro_torch.core import ptlrpc as R

PAGE_SIZE = 4096
DEFAULT_MAX_PAGES_PER_RPC = 1024      # 4 MiB per BRW RPC
DEFAULT_MAX_RPCS_IN_FLIGHT = 8
DEFAULT_MAX_CACHED_MB = 64            # clean read-cache budget per OSC
DEFAULT_READAHEAD_PAGES = 256         # 1 MiB sequential readahead window


def _pages(nbytes: int) -> int:
    return max(1, (nbytes + PAGE_SIZE - 1) // PAGE_SIZE)


@dataclasses.dataclass
class DirtyExtent:
    group: int
    oid: int
    offset: int
    data: bytes
    mtime: float

    @property
    def end(self) -> int:
        return self.offset + len(self.data)


@dataclasses.dataclass
class CleanExtent:
    """A lock-covered cached extent of clean data (read or written-back).
    Validity is NOT stored here: it is re-checked against the client lock
    cache on every hit (the pages are usable exactly while a cached PR/PW
    lock covers them)."""
    group: int
    oid: int
    offset: int
    data: bytes
    atime: float                       # LRU clock

    @property
    def end(self) -> int:
        return self.offset + len(self.data)


class Osc:
    def __init__(self, rpc: R.RpcClient, target_uuid: str, nids: list[str],
                 *, writeback: bool = True,
                 max_pages_per_rpc: int = DEFAULT_MAX_PAGES_PER_RPC,
                 max_rpcs_in_flight: int = DEFAULT_MAX_RPCS_IN_FLIGHT,
                 vectored_brw: bool = True,
                 max_cached_mb: int = DEFAULT_MAX_CACHED_MB):
        self.rpc = rpc
        self.sim = rpc.sim
        self.uuid = target_uuid
        self.imp = rpc.import_target(target_uuid, nids, "ost")
        self.locks = dlm_mod.LockClient(rpc, self.imp, flush_cb=self._flush_lock)
        self.locks.revoke_cbs.append(self._on_lock_revoked)
        self.locks.glimpse_cb = self._on_glimpse
        self.imp.evict_cbs.append(self._on_evicted)
        self.writeback = writeback
        self.max_pages_per_rpc = max(1, max_pages_per_rpc)
        self.max_rpcs_in_flight = max(1, max_rpcs_in_flight)
        self.vectored_brw = vectored_brw
        self.dirty: list[DirtyExtent] = []
        self.dirty_bytes = 0
        # clean read cache: per-object sorted disjoint extents, global
        # LRU byte budget (max_cached_mb)
        self.clean: dict[tuple, list[CleanExtent]] = defaultdict(list)
        self.clean_bytes = 0
        self.max_cached_bytes = max(0, max_cached_mb) << 20
        # size/mtime known-under-lock (LVB, §7.7): valid while a cached
        # whole-object PR/PW lock is held
        self._sizes: dict[tuple, int] = {}
        self._mtimes: dict[tuple, float] = {}
        self.grant = 0
        self._cobd_imports: dict[str, R.Import] = {}
        self.read_cache_cb = None       # COBD hook: populate peer cache

    # ------------------------------------------------------------- locks
    def _res(self, group, oid):
        return ("ext", group, oid)

    def lock(self, group, oid, mode, extent=None, gid: int = 0,
             glimpse: bool = False):
        lk, _, lvb = self.locks.enqueue(self._res(group, oid), mode,
                                        extent or dlm_mod.WHOLE, gid=gid,
                                        glimpse=glimpse)
        if lk is not None and lk.covers("PR", dlm_mod.WHOLE) \
                and "size" in lvb:
            # whole-object PR/PW lock: the LVB size/mtime stay current
            # (nobody else can write) modulo our own tracked writes
            key = (group, oid)
            self._sizes.setdefault(key, lvb["size"])
            self._mtimes.setdefault(key, lvb.get("mtime", 0.0))
        return lk, lvb

    def _flush_lock(self, lk: dlm_mod.Lock):
        """Blocking AST on a PW lock: write back dirty extents under it."""
        _, group, oid = lk.res_name
        self.flush(group, oid)

    def _on_glimpse(self, lk: dlm_mod.Lock) -> dict:
        """Glimpse AST: report the live size/mtime this client knows —
        tracked lock-cached size plus dirty write-back extents — WITHOUT
        flushing or surrendering the lock (§7.7)."""
        if lk.res_name[0] != "ext":
            return {}
        _, group, oid = lk.res_name
        key = (group, oid)
        size = self._sizes.get(key, 0)
        mtime = self._mtimes.get(key, 0.0)
        for d in self.dirty:
            if (d.group, d.oid) == key:
                size = max(size, d.end)
                mtime = max(mtime, d.mtime)
        self.sim.stats.count("osc.glimpse_answered")
        return {"size": size, "mtime": mtime}

    def _on_lock_revoked(self, lk: dlm_mod.Lock):
        """A lock left the cache (AST / cancel / eviction): every clean
        page it covered is no longer protected — drop them, plus the
        LVB-derived size (§7.4: flush AND invalidate on revocation)."""
        if lk.res_name[0] != "ext":
            return
        _, group, oid = lk.res_name
        self._invalidate_clean(group, oid, lk.extent)
        self._sizes.pop((group, oid), None)
        self._mtimes.pop((group, oid), None)

    def _on_evicted(self):
        """The OST evicted us (-107): locks, grant, dirty data and clean
        pages are all void. Dirty bytes are LOST — the documented cost of
        eviction (§7.4)."""
        self.sim.stats.count("osc.evicted")
        if self.dirty_bytes:
            self.sim.stats.count("osc.evicted_dirty_lost_bytes",
                                 self.dirty_bytes)
        self.dirty.clear()
        self.dirty_bytes = 0
        self.clean.clear()
        self.clean_bytes = 0
        self._sizes.clear()
        self._mtimes.clear()
        self.grant = 0
        self.locks.drop_all()

    # ------------------------------------------------------------- admin
    @property
    def active(self) -> bool:
        return not self.imp.deactivated

    def set_active(self, on: bool):
        """`lctl --device <osc> activate|deactivate` analogue. While
        inactive every RPC through this OSC fails fast with -19 (ENODEV)
        instead of paying the reconnect walk; the LOV's raid5 paths key
        degraded service off exactly that."""
        self.imp.deactivated = not on

    # --------------------------------------------------------------- api
    def create(self, group: int, oid: int | None = None, **attrs) -> dict:
        def fixup(req, rep):
            req.body["oid"] = rep.data["oid"]
        rep = self.imp.request("create", {"group": group, "oid": oid,
                                          "attrs": attrs}, fixup=fixup)
        return rep.data

    def destroy(self, group: int, oid: int, cookie: int | None = None):
        return self.imp.request("destroy", {"group": group, "oid": oid,
                                            "cookie": cookie}).data

    def getattr(self, group: int, oid: int) -> dict:
        return self.imp.request("getattr", {"group": group, "oid": oid}).data

    def glimpse_bulk(self, items: list) -> list:
        """ONE vectored glimpse RPC for many objects of this OST:
        items = [(group, oid), ...] -> [{"size", "mtime"} | None, ...].
        Writers holding PW locks answer glimpse ASTs server-side; their
        caches survive (unlike the PR-enqueue revocation path)."""
        rep = self.imp.request("glimpse_bulk",
                               {"objects": [list(i) for i in items]})
        self.sim.stats.count("osc.glimpse_bulk")
        return rep.data["attrs"]

    def setattr(self, group: int, oid: int, **attrs):
        return self.imp.request(
            "setattr", {"group": group, "oid": oid, "attrs": attrs}).data

    def punch(self, group: int, oid: int, size: int):
        self._drop_dirty_beyond(group, oid, size)
        self._invalidate_clean(group, oid, (size, dlm_mod.MAX_EXT))
        key = (group, oid)
        if key in self._sizes:
            self._sizes[key] = min(self._sizes[key], size)
        return self.imp.request(
            "punch", {"group": group, "oid": oid, "size": size}).data

    def statfs(self) -> dict:
        return self.imp.request("statfs", {}).data

    def sync(self):
        self.flush()
        return self.imp.request("sync", {}).data

    def list_objects(self, group: int) -> list:
        return self.imp.request("list_objects", {"group": group}).data

    # --------------------------------------------------------------- I/O
    def _ensure_grant(self):
        if self.grant == 0:
            self.grant = self.imp.connect_data.get("grant", 0)

    def write(self, group: int, oid: int, offset: int, data: bytes,
              *, lock: bool = True, gid: int = 0):
        if not data:
            return {"cached": False, "size": None}
        if lock:
            self.lock(group, oid, "GR" if gid else "PW",
                      (offset, offset + len(data)), gid=gid)
        self._ensure_grant()
        if self.writeback and len(data) <= self.grant:
            # cached write consumes grant; flushed lazily (ch. 10.12)
            self.grant -= len(data)
            self._note_write(group, oid, offset, len(data))
            self._cache_dirty(group, oid, offset, data)
            for lk in self.locks.by_res.get(self._res(group, oid), ()):
                lk.dirty = True
            self.sim.stats.count("osc.cached_write")
            return {"cached": True}
        # write-through: older cached extents of this object must land
        # FIRST or a later flush would overwrite this newer data
        self.flush(group, oid)
        # AFTER the flush: it promotes the older extents to clean pages,
        # which this newer write supersedes
        self._note_write(group, oid, offset, len(data))
        return self._write_through(
            DirtyExtent(group, oid, offset, bytes(data), self.sim.now))

    def writev(self, group: int, oid: int, iov: list, *, lock: bool = True,
               gid: int = 0):
        """Vectored write: iov = [(offset, data), ...] for ONE object.
        Takes a single lock spanning the runs, then either caches the runs
        (write-back) or ships them as coalesced BRW niobuf vectors."""
        iov = [(off, d) for off, d in iov if d]
        if not iov:
            return {"cached": False}
        total = sum(len(d) for _, d in iov)
        if lock:
            span = (min(off for off, _ in iov),
                    max(off + len(d) for off, d in iov))
            self.lock(group, oid, "GR" if gid else "PW", span, gid=gid)
        self._ensure_grant()
        if self.writeback and total <= self.grant:
            self.grant -= total
            for off, d in iov:
                self._note_write(group, oid, off, len(d))
                self._cache_dirty(group, oid, off, d)
            for lk in self.locks.by_res.get(self._res(group, oid), ()):
                lk.dirty = True
            self.sim.stats.count("osc.cached_write", len(iov))
            return {"cached": True}
        # write-through (see write()): flush older cached data first —
        # the flush promotes them to clean, which these newer runs
        # supersede (_note_write after it)
        self.flush(group, oid)
        for off, d in iov:
            self._note_write(group, oid, off, len(d))
        now = self.sim.now
        exts = [DirtyExtent(group, oid, off, bytes(d), now) for off, d in iov]
        if not self.vectored_brw:
            outs = self.sim.parallel([
                (lambda dd=d: self._write_through(dd)) for d in exts])
            return outs[-1] if outs else {"cached": False}
        outs = self._send_vectors(self._build_vectors(exts))
        return outs[-1] if outs else {"cached": False}

    # ------------------------------------------------------- dirty cache
    def _cache_dirty(self, group: int, oid: int, offset: int, data: bytes):
        """Insert a dirty extent, coalescing with overlapping/adjacent
        extents of the same object (new data wins over old) so the cache
        stays normalized: per-object extents are sorted and disjoint."""
        if not self.vectored_brw:
            self.dirty.append(DirtyExtent(group, oid, offset, bytes(data),
                                          self.sim.now))
            self.dirty_bytes += len(data)
            return
        end = offset + len(data)
        touch = [d for d in self.dirty
                 if (d.group, d.oid) == (group, oid)
                 and d.offset <= end and offset <= d.end]
        if not touch:
            merged = DirtyExtent(group, oid, offset, bytes(data),
                                 self.sim.now)
        else:
            lo = min(offset, min(d.offset for d in touch))
            hi = max(end, max(d.end for d in touch))
            buf = bytearray(hi - lo)
            # lay old extents in temporal (list) order, newest write last
            for d in touch:
                buf[d.offset - lo:d.end - lo] = d.data
                self.dirty.remove(d)
                self.dirty_bytes -= len(d.data)
            buf[offset - lo:end - lo] = data
            merged = DirtyExtent(group, oid, lo, bytes(buf), self.sim.now)
            self.sim.stats.count("osc.extents_coalesced", len(touch))
        self.dirty.append(merged)
        self.dirty_bytes += len(merged.data)

    # ------------------------------------------------------- clean cache
    def _note_write(self, group: int, oid: int, offset: int, nbytes: int):
        """A write supersedes any clean pages it overlaps and grows the
        lock-cached size."""
        if nbytes <= 0:
            return
        self._invalidate_clean(group, oid, (offset, offset + nbytes))
        key = (group, oid)
        if key in self._sizes:
            self._sizes[key] = max(self._sizes[key], offset + nbytes)
            self._mtimes[key] = max(self._mtimes.get(key, 0.0),
                                    self.sim.now)

    def _clean_insert(self, group: int, oid: int, offset: int,
                      data: bytes):
        """Cache a clean extent, coalescing with overlapping/adjacent
        cached extents (new data wins), then enforce the LRU byte budget."""
        if not data or not self.max_cached_bytes:
            return
        key = (group, oid)
        end = offset + len(data)
        exts = self.clean[key]
        touch = [e for e in exts if e.offset <= end and offset <= e.end]
        if not touch:
            merged = CleanExtent(group, oid, offset, bytes(data),
                                 self.sim.now)
        else:
            lo = min(offset, min(e.offset for e in touch))
            hi = max(end, max(e.end for e in touch))
            buf = bytearray(hi - lo)
            for e in touch:
                buf[e.offset - lo:e.end - lo] = e.data
                exts.remove(e)
                self.clean_bytes -= len(e.data)
            buf[offset - lo:end - lo] = data
            merged = CleanExtent(group, oid, lo, bytes(buf), self.sim.now)
        exts.append(merged)
        exts.sort(key=lambda e: e.offset)
        self.clean_bytes += len(merged.data)
        self._clean_shrink()

    def _clean_shrink(self):
        """LRU-evict whole extents until the cache fits max_cached_mb."""
        while self.clean_bytes > self.max_cached_bytes:
            victim = min((e for exts in self.clean.values() for e in exts),
                         key=lambda e: e.atime)
            vkey = (victim.group, victim.oid)
            self.clean[vkey].remove(victim)
            if not self.clean[vkey]:
                del self.clean[vkey]
            self.clean_bytes -= len(victim.data)
            self.sim.stats.count("osc.cache_lru_evict")

    def _clean_read(self, group: int, oid: int, offset: int,
                    length: int) -> bytes | None:
        """Serve from the clean cache iff a cached PR/PW lock covers the
        extent (the §7.4 validity rule) — zero RPCs on a hit."""
        exts = self.clean.get((group, oid))
        if not exts:
            return None
        end = offset + length
        for e in exts:
            if e.offset <= offset and end <= e.end:
                if self.locks.match(self._res(group, oid), "PR",
                                    (offset, end)) is None:
                    # no covering lock: the pages are unprotected — a
                    # revocation should already have dropped them, but
                    # never serve unguarded data (count + drop)
                    self.sim.stats.count("osc.cache_uncovered")
                    self._invalidate_clean(group, oid, (e.offset, e.end))
                    return None
                e.atime = self.sim.now
                self.sim.stats.count("osc.cache_hit")
                self.sim.stats.count("osc.cache_hit_bytes", length)
                o = offset - e.offset
                return e.data[o:o + length]
        return None

    def _invalidate_clean(self, group: int, oid: int,
                          extent: tuple | None = None):
        """Drop clean pages overlapping `extent` (None = whole object)."""
        key = (group, oid)
        exts = self.clean.get(key)
        if not exts:
            return
        lo, hi = extent if extent is not None else (0, dlm_mod.MAX_EXT)
        keep = []
        for e in exts:
            if e.offset < hi and lo < e.end:
                self.clean_bytes -= len(e.data)
                self.sim.stats.count("osc.cache_invalidate")
            else:
                keep.append(e)
        if keep:
            self.clean[key] = keep
        else:
            self.clean.pop(key, None)

    # ------------------------------------------------------- BRW engine
    def _pack(self, items: list, nbytes_of) -> list[list]:
        """Pack items (pre-sorted by offset) into batches whose combined
        page count stays within max_pages_per_rpc."""
        batches, vec, pages = [], [], 0
        for it in items:
            npg = _pages(nbytes_of(it))
            if vec and pages + npg > self.max_pages_per_rpc:
                batches.append(vec)
                vec, pages = [], 0
            vec.append(it)
            pages += npg
        if vec:
            batches.append(vec)
        return batches

    def _build_vectors(self, extents: list[DirtyExtent]) -> list[tuple]:
        """Group extents by object and pack them, sorted by offset, into
        niobuf vectors of at most max_pages_per_rpc pages each.
        Returns [(group, oid, [DirtyExtent, ...]), ...]."""
        max_bytes = self.max_pages_per_rpc * PAGE_SIZE
        by_obj: dict[tuple, list[DirtyExtent]] = defaultdict(list)
        for d in extents:
            # an extent larger than one RPC's page budget is sliced first
            for cut in range(0, len(d.data), max_bytes):
                by_obj[(d.group, d.oid)].append(
                    DirtyExtent(d.group, d.oid, d.offset + cut,
                                d.data[cut:cut + max_bytes], d.mtime))
        rpcs = []
        for (g, o), exts in by_obj.items():
            for vec in self._pack(sorted(exts, key=lambda d: d.offset),
                                  lambda d: len(d.data)):
                rpcs.append((g, o, vec))
        return rpcs

    def _brw_write(self, group: int, oid: int, vec: list[DirtyExtent]) -> dict:
        # bulk bytes ride in the body niobufs: wire_size counts them once;
        # no extra bulk_nbytes or we double-charge the link
        rep = self.imp.request(
            "write", {"group": group, "oid": oid,
                      "niobufs": [{"offset": d.offset, "data": d.data}
                                  for d in vec],
                      "mtime": max(d.mtime for d in vec)})
        self.grant = rep.data.get("grant", self.grant)
        self._note_written_size(group, oid, rep.data)
        self.sim.stats.count("osc.brw_write_rpc")
        self.sim.stats.count("osc.brw_write_niobufs", len(vec))
        return rep.data

    def _note_written_size(self, group: int, oid: int, rep_data: dict):
        """Write replies carry the post-write object size: keep the
        lock-cached size current so getattr_locked stays RPC-free."""
        key = (group, oid)
        if key in self._sizes and isinstance(rep_data, dict) \
                and "size" in rep_data:
            self._sizes[key] = max(self._sizes[key], rep_data["size"])

    def _send_vectors(self, rpcs: list[tuple]) -> list:
        """Dispatch BRW RPCs with at most max_rpcs_in_flight concurrent."""
        outs = []
        for i in range(0, len(rpcs), self.max_rpcs_in_flight):
            window = rpcs[i:i + self.max_rpcs_in_flight]
            outs.extend(self.sim.parallel(
                [(lambda r=r: self._brw_write(*r)) for r in window]))
        return outs

    def _write_through(self, d: DirtyExtent) -> dict:
        if self.vectored_brw:
            outs = self._send_vectors(self._build_vectors([d]))
            return outs[-1]
        # legacy (seed) path: one RPC per extent, data in the body
        rep = self.imp.request(
            "write", {"group": d.group, "oid": d.oid, "offset": d.offset,
                      "data": d.data, "mtime": d.mtime})
        self.grant = rep.data.get("grant", self.grant)
        self._note_written_size(d.group, d.oid, rep.data)
        return rep.data

    def flush(self, group=None, oid=None):
        """Write back dirty extents (all, or one object's), coalesced into
        vectored BRW RPCs under in-flight flow control. Flushed pages are
        not thrown away: they stay cached as CLEAN extents, still covered
        by the PW lock the write took."""
        todo = [d for d in self.dirty
                if group is None or (d.group, d.oid) == (group, oid)]
        if not todo:
            if group is None:
                # idle full flush (e.g. close after a blocking AST already
                # wrote everything back): still the moment to return grant
                self._maybe_shrink_grant()
            return 0
        act = fail_mod.state.check("osc.flush")
        if act == "delay":
            pass                       # check() already stalled the clock
        elif act in ("drop", "crash"):
            # client-side site: the flush's first BRW RPC is lost on the
            # wire (OBD_FAIL_*_NET); the import recovers via timeout ->
            # reconnect -> resend, so the flush still completes
            self.sim.faults.drop_next[self.imp.active_nid] += 1
        if self.vectored_brw:
            self._send_vectors(self._build_vectors(todo))
        else:
            self.sim.parallel([
                (lambda dd=d: self._write_through(dd)) for d in todo])
        # drop from the cache only once the writes went out: a failed
        # flush (ENOSPC, unreachable target) must not discard dirty data
        for d in todo:
            self.dirty.remove(d)
            self.dirty_bytes -= len(d.data)
            self._clean_insert(d.group, d.oid, d.offset, d.data)
        if group is None:
            # full flush = the write burst is over: return idle grant so
            # the OST can redistribute it (ch. 10.12 grant shrinking —
            # at thousands of clients the per-export slice is the scarce
            # resource, see benchmarks/bench_scale.py)
            self._maybe_shrink_grant()
        return len(todo)

    def _maybe_shrink_grant(self):
        """Give back grant above the connect-time watermark once no dirty
        data needs it. The RPC carries the absolute `keep` target, so a
        resend after a drop/crash is idempotent (shrinking to 2 MB twice
        is shrinking to 2 MB)."""
        keep = self.imp.connect_data.get("grant", 0)
        if self.dirty or keep <= 0 or self.grant <= keep:
            return
        act = fail_mod.state.check("osc.grant_shrink")
        if act in ("drop", "crash"):
            # client-side site: the shrink RPC is lost on the wire; the
            # import recovers via timeout -> reconnect -> resend
            self.sim.faults.drop_next[self.imp.active_nid] += 1
        try:
            rep = self.imp.request("grant_shrink", {"keep": keep})
        except (R.TimeoutError_, R.RpcError):
            return                     # best-effort: grant is a hint
        self.grant = min(self.grant, rep.data.get("grant", keep))
        self.sim.stats.count("osc.grant_shrink", node=self.rpc.uuid)

    def _drop_dirty_beyond(self, group, oid, size):
        for d in list(self.dirty):
            if (d.group, d.oid) == (group, oid) and d.offset >= size:
                self.dirty.remove(d)
                self.dirty_bytes -= len(d.data)

    # --------------------------------------------------------------- read
    def _cached_read(self, group, oid, offset, length) -> bytes | None:
        for d in self.dirty:
            if (d.group, d.oid) == (group, oid) and d.offset <= offset and \
                    offset + length <= d.end:
                o = offset - d.offset
                return d.data[o:o + length]
        return None

    def read(self, group: int, oid: int, offset: int, length: int,
             *, lock: bool = True, from_cobd: str | None = None) -> bytes:
        # serve from own dirty cache when fully covered
        hit = self._cached_read(group, oid, offset, length)
        if hit is not None:
            return hit
        # then from the clean cache, if a cached lock still covers it
        hit = self._clean_read(group, oid, offset, length)
        if hit is not None:
            return hit
        self.sim.stats.count("osc.cache_miss")
        self.flush(group, oid)             # partial overlap: write back first
        if lock:
            self.lock(group, oid, "PR", (offset, offset + length))
        body = {"group": group, "oid": oid, "offset": offset,
                "length": length}
        if from_cobd:
            body["_from_cobd"] = from_cobd
        rep = self.imp.request("read", body)
        if rep.data and "referral" in (rep.data or {}):
            ref = rep.data["referral"]
            self.sim.stats.count("osc.followed_referral")
            data = self._read_via(ref, group, oid, offset, length)
        else:
            data = rep.bulk
        if self.locks.match(self._res(group, oid), "PR",
                            (offset, offset + len(data or b""))):
            self._clean_insert(group, oid, offset, data)
        return data

    def readv(self, group: int, oid: int, iov: list,
              *, lock: bool = True) -> list[bytes]:
        """Vectored read: iov = [(offset, length), ...] for ONE object.
        One lock spanning the runs; uncached runs travel as niobuf vectors
        in as few OST_READ RPCs as max_pages_per_rpc allows; replies are
        merged with cache hits positionally."""
        iov = list(iov)
        if not iov:
            return []
        if not self.vectored_brw:
            return [self.read(group, oid, off, ln, lock=lock)
                    for off, ln in iov]
        out: list[Optional[bytes]] = [None] * len(iov)
        miss: list[tuple[int, int, int]] = []      # (iov_idx, offset, length)
        for i, (off, ln) in enumerate(iov):
            hit = self._cached_read(group, oid, off, ln)
            if hit is None:
                hit = self._clean_read(group, oid, off, ln)
            if hit is not None:
                out[i] = hit
            else:
                self.sim.stats.count("osc.cache_miss")
                miss.append((i, off, ln))
        if not miss:
            return out                       # fully served from cache
        self.flush(group, oid)               # partial overlap: write back
        span = (min(off for _, off, _ in miss),
                max(off + ln for _, off, ln in miss))
        if lock:
            self.lock(group, oid, "PR", span)
        # pack misses into vectors bounded by max_pages_per_rpc
        batches = self._pack(sorted(miss, key=lambda m: m[1]),
                             lambda m: m[2])

        def one(batch):
            rep = self.imp.request(
                "read", {"group": group, "oid": oid,
                         "niobufs": [{"offset": off, "length": ln}
                                     for _, off, ln in batch]})
            if rep.data and "referral" in (rep.data or {}):
                # collaborative-cache referral: fall back to per-run reads
                # (they follow the referral chain)
                self.sim.stats.count("osc.followed_referral")
                return [self.read(group, oid, off, ln, lock=False)
                        for _, off, ln in batch]
            self.sim.stats.count("osc.brw_read_rpc")
            return rep.bulk
        covered = bool(lock) or self.locks.match(
            self._res(group, oid), "PR", span) is not None
        for i in range(0, len(batches), self.max_rpcs_in_flight):
            window = batches[i:i + self.max_rpcs_in_flight]
            chunk_lists = self.sim.parallel(
                [(lambda b=b: one(b)) for b in window])
            for batch, chunks in zip(window, chunk_lists):
                for (idx, off, _), chunk in zip(batch, chunks):
                    out[idx] = chunk
                    if covered:
                        self._clean_insert(group, oid, off, chunk)
        return out

    def getattr_locked(self, group: int, oid: int) -> dict:
        """size/mtime under a PR lock. While a cached whole-object PR/PW
        lock is held nobody else can change the object, so the grant-time
        LVB (§7.7) plus our own tracked writes IS the current size — zero
        RPCs on the warm path. The cold enqueue is a GLIMPSE enqueue: a
        conflicting writer is ASKED for its LVB via a glimpse AST instead
        of revoked, so a stat of a file under write no longer kills the
        writer's write-back cache (the ROADMAP'd 'glimpse ASTs proper')."""
        key = (group, oid)
        if key not in self._sizes or self.locks.match(
                self._res(group, oid), "PR", dlm_mod.WHOLE) is None:
            lk, lvb = self.lock(group, oid, "PR", glimpse=True)
            if lk is None and "size" in lvb:
                # writer active: the server merged the holders' glimpse
                # answers into the LVB — use it, cache nothing (no lock)
                self.sim.stats.count("osc.glimpse_stat")
                return {"size": lvb["size"], "mtime": lvb.get("mtime", 0.0)}
            if not (lk is not None and lk.covers("PR", dlm_mod.WHOLE)
                    and key in self._sizes):
                # contended object (lock not grown to whole): fall back
                a = self.getattr(group, oid)
                return {"size": a["size"], "mtime": a["mtime"]}
        else:
            self.sim.stats.count("osc.getattr_cached")
        size = self._sizes[key]
        mtime = self._mtimes.get(key, 0.0)
        for d in self.dirty:
            if (d.group, d.oid) == key:
                size = max(size, d.end)
                mtime = max(mtime, d.mtime)
        return {"size": size, "mtime": mtime}

    def _read_via(self, ref: dict, group, oid, offset, length) -> bytes:
        imp = self._cobd_imports.get(ref["uuid"])
        if imp is None:
            imp = self.rpc.import_target(ref["uuid"], [ref["nid"]], "ost")
            self._cobd_imports[ref["uuid"]] = imp
        rep = imp.request("read", {"group": group, "oid": oid,
                                   "offset": offset, "length": length,
                                   "no_referral": True})
        return rep.bulk

    # ---------------------------------------------------------- recovery
    def on_connect_data(self, data: dict):
        self.grant = data.get("grant", 0)
