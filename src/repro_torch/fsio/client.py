"""LustreClient: the client filesystem (paper ch. 9, 28 — "Lustre Lite").

POSIX-ish API over the LMV (metadata) + LOV (data) stacks:
  * path resolution with a *dentry cache* guarded by DLM locks — an entry is
    valid exactly while its PR lock is held; server-side updates revoke via
    blocking ASTs (ch. 28.4); negative entries are cached too (§6.2.1);
  * `open(path, "cw")` is ONE intent RPC doing lookup+create+open (§6.4.3);
    the client then creates the stripe objects and writes the LOV EA back
    (the MDS returned the new inode under a lock so only this client
    creates objects);
  * file I/O through LOV striping under extent locks, write-back cached
    with grants (ch. 10, 28.5);
  * size/mtime: while a file is open for write the OSTs own mtime/size;
    `close` ships them to the MDS (§6.9.1); `stat` consults the OSTs when
    the MDS flag says so — via batched glimpse ASTs that leave the
    writers' PW locks and caches intact (§7.7);
  * metadata read-path batching: readdir-plus paged scans
    (`dir_pages`), a fid-keyed attribute cache valid exactly while the
    covering DLM lock is held (revocation-invalidated like the dentry
    cache), and a statahead pipeline prefetching attr windows for
    sequential stat patterns (`statahead_max`);
  * optional metadata write-back-cache mode for create-heavy directories
    (ch. 17).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import defaultdict
from typing import Optional

from repro_torch.core import fail as fail_mod
from repro_torch.core import lov as lov_mod
from repro_torch.core import mdc as mdc_mod
from repro_torch.core import osc as osc_mod
from repro_torch.core import mds as mds_mod
from repro_torch.core import ptlrpc as R
from repro_torch.core import recovery as rec_mod
from repro_torch.core.cluster import LustreCluster

ROOT = mds_mod.ROOT_FID


class FsError(Exception):
    def __init__(self, errno: int, msg: str = ""):
        super().__init__(f"errno {errno}: {msg}")
        self.errno = errno


@dataclasses.dataclass
class FileHandle:
    fid: tuple
    lsm: Optional[lov_mod.StripeMd]
    open_handle: int
    flags: str
    pos: int = 0
    max_written: int = 0
    mtime: float = 0.0
    # per-handle sequential-read detector state (readahead):
    ra_next: int = 0           # offset the next sequential read starts at
    ra_window: int = 0         # current readahead window (bytes, ramps up)
    ra_pos: int = 0            # how far readahead has already fetched
    # opened through the metadata write-back cache: no MDS open handle,
    # close() records size/mtime as a cache record instead of an RPC
    wbc: bool = False


@dataclasses.dataclass
class Dentry:
    fid: tuple | None            # None = negative entry
    attrs: dict | None
    lock_handle: int | None      # validity = lock still held
    # which Mdc's lock cache holds the covering lock (split-dir bucket
    # pages are covered by the BUCKET MDS's lock, not the master's);
    # None = the parent fid's own Mdc (the common case)
    mdc: object = None


@dataclasses.dataclass
class CachedAttr:
    """One fid's cached attributes (+EA), valid exactly while the
    covering DLM lock — the PR lock of a directory the inode is linked
    in — is still in `mdc`'s lock cache. The MDS revokes that lock on
    ANY attr change (setattr/close/open-for-write) via the inode's
    pfids, so validity mirrors the dentry cache."""
    attrs: dict
    ea: dict
    mdc: object
    lock_handle: int


class _Statahead:
    """Per-directory sequential-stat detector: the metadata analogue of
    the readahead detector. `order` is the last readdir(-plus)
    order; stats walking it in order ramp a prefetch window."""

    __slots__ = ("order", "index", "pos", "run", "fetched")

    def __init__(self, order):
        self.order = list(order)           # [(name, fid), ...]
        self.index = {n: i for i, (n, _) in enumerate(self.order)}
        self.pos = -1                      # index of the last stat
        self.run = 0                       # sequential-run length
        self.fetched = 0                   # prefetch horizon (index)


class LustreClient:
    def __init__(self, cluster: LustreCluster, node_idx: int = 0,
                 default_stripe_count: int = 0,
                 default_stripe_size: int = 1 << 20,
                 max_pages_per_rpc: int | None = None,
                 max_rpcs_in_flight: int | None = None,
                 vectored_brw: bool | None = None,
                 max_cached_mb: int | None = None,
                 readahead_pages: int | None = None,
                 dir_pages: int | None = None,
                 statahead_max: int | None = None,
                 wbc_auto: bool | None = None,
                 wbc_batch: int | None = None,
                 wbc_max_dirty: int | None = None):
        self.cluster = cluster
        self.rpc = cluster.make_client_rpc(node_idx)
        self.lmv = cluster.make_lmv(self.rpc)
        # BRW pipeline + read cache knobs: per-client override of the
        # cluster defaults
        osc_kw = {k: v for k, v in (
            ("max_pages_per_rpc", max_pages_per_rpc),
            ("max_rpcs_in_flight", max_rpcs_in_flight),
            ("vectored_brw", vectored_brw),
            ("max_cached_mb", max_cached_mb)) if v is not None}
        self.lov = cluster.make_lov(self.rpc, **osc_kw)
        self.readahead_pages = cluster.readahead_pages \
            if readahead_pages is None else readahead_pages
        # metadata read-path knobs: readdir-plus page size
        # (0 = per-entry seed path) + statahead prefetch window (0 off)
        self.dir_pages = cluster.dir_pages if dir_pages is None \
            else dir_pages
        self.statahead_max = cluster.statahead_max if statahead_max is None \
            else statahead_max
        # metadata write-back knobs: wbc_auto enters WBC mode
        # on the first metadata write under a directory (the §6.5.2
        # contention decision on the MDS still gets the final say);
        # wbc_batch/wbc_max_dirty drive the background flush pipeline
        self.wbc_auto = cluster.wbc_auto if wbc_auto is None else wbc_auto
        self.wbc_batch = cluster.wbc_batch if wbc_batch is None \
            else wbc_batch
        self.wbc_max_dirty = cluster.wbc_max_dirty if wbc_max_dirty is None \
            else wbc_max_dirty
        self.wbc_max_rpcs = cluster.max_rpcs_in_flight \
            if max_rpcs_in_flight is None else max_rpcs_in_flight
        self._wbc_denied: set = set()   # parents the MDS refused WBC for
        self.sim = cluster.sim
        # eviction by an MDS voids every lock that guards the dentry
        # cache: drop the locks (local-only) and the dentries with them;
        # lock revocation (AST/cancel) drops the attr-cache entries the
        # lock covered — same machinery as the OSC clean cache
        for mdc in self.lmv.mdcs:
            mdc.imp.evict_cbs.append(
                lambda m=mdc: self._on_mds_evicted(m))
            mdc.locks.revoke_cbs.append(
                lambda lk, m=mdc: self._attrs_revoked(m, lk))
        self.default_stripe_count = default_stripe_count or len(
            cluster.ost_targets)
        self.default_stripe_size = default_stripe_size
        self.dcache: dict[tuple, Dentry] = {}     # (parent, name) -> Dentry
        # fid-keyed attribute cache, validity tied to the covering DLM
        # lock exactly like the dentry cache
        self.attr_cache: dict[tuple, CachedAttr] = {}
        self._attr_by_lock: dict[tuple, set] = defaultdict(set)
        # statahead pipeline state: per-dir detectors + one-shot results
        # for entries no held lock covers (remote-MDT attrs, glimpses)
        self._sa: dict[tuple, _Statahead] = {}
        self._sa_attrs: dict[tuple, dict] = {}
        self._sa_glimpse: dict[tuple, dict] = {}
        # negative-entry windows: dir fid -> (page locks,
        # names seen) from a COMPLETE readdir-plus pass — while every
        # page lock survives, any other name is known absent (ENOENT
        # with zero RPCs)
        self._neg_win: dict[tuple, tuple[list, set]] = {}
        self._fh = itertools.count(1)
        self.handles: dict[int, FileHandle] = {}
        self.wbc: mdc_mod.WbcCache | None = None
        # active health plane: one pinger over every import;
        # a ping-detected OST death marks it inactive in the LOV (raid5
        # serves degraded with zero RPCs at the corpse) and a detected
        # restart triggers imperative recovery. Drive with pinger.tick()
        # — nothing ticks it implicitly.
        self.pinger = rec_mod.Pinger(
            [o.imp for o in self.lov.oscs + self.lov.spares]
            + [m.imp for m in self.lmv.mdcs],
            lov=self.lov)

    # ------------------------------------------------------------- mount
    def mount(self) -> "LustreClient":
        self.lmv.getattr(ROOT)
        return self

    # ------------------------------------------------------ path walking
    @staticmethod
    def _parts(path: str) -> list[str]:
        return [p for p in path.split("/") if p]

    def _dentry_valid(self, key, mdc) -> bool:
        d = self.dcache.get(key)
        if d is None:
            return False
        if d.lock_handle is None:
            return False
        owner = d.mdc if d.mdc is not None else mdc
        return d.lock_handle in owner.locks.locks

    def _lookup(self, parent: tuple, name: str) -> Dentry:
        key = (tuple(parent), name)
        mdc = self.lmv.mdc_for_fid(parent)
        if self._dentry_valid(key, mdc):
            self.sim.stats.count("fs.dcache_hit")
            return self.dcache[key]
        d = self._neg_lookup(key)
        if d is not None:
            return d
        lk, data = self.lmv.getattr_lock(parent, name, want_ea=True)
        idx = data.get("_granted_by")
        gmdc = self.lmv.mdcs[idx] if idx is not None else mdc
        if data.get("status", 0) == -2:
            d = Dentry(None, None, lk.handle if lk else None, gmdc)
        elif data.get("status", 0) != 0:
            raise FsError(data["status"], name)
        else:
            d = Dentry(tuple(data["attrs"]["fid"]), dict(data["attrs"]),
                       lk.handle if lk else None, gmdc)
            if "ea" in data:
                d.attrs["_ea"] = data["ea"]
            # the looked-up attrs ride under the same dir lock as the
            # dentry — cache them (the 2nd-hop remote path is flagged
            # `_remote`: its attrs have no covering lock here)
            if lk is not None and not data.get("_remote"):
                self._attr_put(d.fid, data["attrs"], data.get("ea"),
                               gmdc, lk.handle)
        self.dcache[key] = d
        return d

    # --------------------------------------------- negative-entry window
    def _neg_install(self, dfid, locks, names):
        """A COMPLETE readdir-plus listing bounds the directory's
        namespace: while every page's PR lock survives, any name NOT in
        the listing is known absent — a later lookup miss answers ENOENT
        with zero RPCs (§6.2.1 negative caching over the whole dir).
        Revoked with the dir lock, exactly like the positive entries."""
        if locks:
            self._neg_win[tuple(dfid)] = (locks, names)

    def _neg_lookup(self, key) -> Dentry | None:
        win = self._neg_win.get(key[0])
        if win is None:
            return None
        locks, names = win
        if any(h not in m.locks.locks for m, h in locks):
            del self._neg_win[key[0]]      # a page lock died: window void
            return None
        if key[1] in names:
            return None                    # listed name: not our answer
        self.sim.stats.count("fs.neg_hit")
        m, h = locks[0]
        d = Dentry(None, None, h, m)
        self.dcache[key] = d
        return d

    # -------------------------------------------------- fid attr cache
    def _attr_put(self, fid, attrs, ea, mdc, lock_handle):
        """Cache `fid`'s attrs under a covering dir lock. No lock, no
        cache — validity IS the lock (§7.4 applied to metadata)."""
        if lock_handle is None or lock_handle not in mdc.locks.locks:
            return
        fid = tuple(fid)
        self._attr_drop(fid)
        self.attr_cache[fid] = CachedAttr(dict(attrs), dict(ea or {}),
                                          mdc, lock_handle)
        self._attr_by_lock[(id(mdc), lock_handle)].add(fid)

    def _attr_drop(self, fid):
        e = self.attr_cache.pop(tuple(fid), None)
        if e is not None:
            s = self._attr_by_lock.get((id(e.mdc), e.lock_handle))
            if s:
                s.discard(tuple(fid))
        # one-shot statahead results for this fid die with it
        self._sa_attrs.pop(tuple(fid), None)
        self._sa_glimpse.pop(tuple(fid), None)

    def _attr_get(self, fid) -> CachedAttr | None:
        e = self.attr_cache.get(tuple(fid))
        if e is None:
            return None
        if e.lock_handle not in e.mdc.locks.locks:
            self._attr_drop(fid)               # lock gone: attrs invalid
            return None
        return e

    def _attrs_revoked(self, mdc, lk):
        """A dir lock left the MDC lock cache (blocking AST / cancel /
        eviction): every attr it covered is unprotected — drop them."""
        for fid in self._attr_by_lock.pop((id(mdc), lk.handle), ()):
            dropped = self.attr_cache.pop(fid, None)
            if dropped is not None:
                self.sim.stats.count("fs.attr_invalidate")

    def resolve(self, path: str, *, follow: bool = True,
                _depth: int = 0) -> tuple:
        if _depth > 8:
            raise FsError(-40, "ELOOP")
        fid = ROOT
        parts = self._parts(path)
        for i, name in enumerate(parts):
            last = i == len(parts) - 1
            if self.wbc is not None and self.wbc.active:
                handled, sfid = self.wbc.child(fid, name)
                if handled and sfid is None:
                    raise FsError(-2, path)     # authoritative ENOENT
                if handled:
                    sa = self.wbc.attrs(sfid)
                    if sa is not None:
                        # shadow-born inode: attrs (symlink target
                        # included) live entirely in the cache
                        if sa.get("type") == "symlink" and (
                                follow or not last):
                            rest = "/".join(parts[i + 1:])
                            target = sa.get("symlink", "")
                            return self.resolve(
                                target + "/" + rest if rest else target,
                                follow=follow, _depth=_depth + 1)
                        fid = sfid
                        continue
                    # pre-existing inode: fall through for real attrs
                    # (symlink detection needs them)
            d = self._lookup(fid, name)
            if d.fid is None:
                raise FsError(-2, path)
            if d.attrs and d.attrs.get("type") == "symlink" and (
                    follow or not last):
                data = self.lmv.getattr(d.fid)
                target = data.get("symlink", "")
                rest = "/".join(parts[i + 1:])
                return self.resolve(target + "/" + rest if rest else target,
                                    follow=follow, _depth=_depth + 1)
            fid = d.fid
        return tuple(fid)

    def _resolve_parent(self, path: str) -> tuple[tuple, str]:
        parts = self._parts(path)
        if not parts:
            raise FsError(-22, path)
        parent = self.resolve("/".join(parts[:-1])) if parts[:-1] else ROOT
        return parent, parts[-1]

    def _invalidate(self, parent: tuple, name: str):
        """Drop our own cached view of an entry we just mutated: the MDS
        spares OUR dir lock from the revocation storm (we are the
        requester), so fixing our caches is our job — the entry's
        dentry + attrs, and the parent dir's own attrs (its
        nlink/nentries changed)."""
        d = self.dcache.pop((tuple(parent), name), None)
        if d is not None and d.fid is not None:
            self._attr_drop(d.fid)
        self._attr_drop(tuple(parent))
        win = self._neg_win.get(tuple(parent))
        if win is not None:
            # we just mutated this entry ourselves: the window can no
            # longer prove the name absent (a create adds it)
            win[1].add(name)

    def _on_mds_evicted(self, mdc):
        """The MDS evicted us: the PR locks guarding cached dentries are
        gone server-side — drop them locally and purge the dcache (the
        drop_all fires revoke_cbs, which purge the attr cache entries
        those locks covered) plus the one-shot statahead results."""
        self.sim.stats.count("fs.evicted_invalidate")
        mdc.locks.drop_all()
        self.dcache.clear()
        self._neg_win.clear()
        self._sa.clear()
        self._sa_attrs.clear()
        self._sa_glimpse.clear()

    # --------------------------------------------------- wbc write routing
    def _make_wbc(self, fid) -> mdc_mod.WbcCache:
        w = mdc_mod.WbcCache(self.lmv, fid, batch=self.wbc_batch,
                             max_dirty=self.wbc_max_dirty,
                             max_rpcs=self.wbc_max_rpcs)
        w.destroy_cb = self._destroy_from_data
        return w

    def _wbc_covering(self, fid) -> mdc_mod.WbcCache | None:
        """The active WBC, if `fid` sits inside its subtree."""
        w = self.wbc
        if w is not None and w.active and w.in_subtree(fid):
            return w
        return None

    def _wbc_for_write(self, parent) -> mdc_mod.WbcCache | None:
        """The WBC a metadata write under `parent` should route through:
        the active cache when it covers the parent; else, with
        `wbc_auto`, an automatic entry attempt — the first metadata
        write under a directory asks the MDS for the subtree lock and
        the §6.5.2 contention decision grants or denies it. A denial is
        remembered (no re-ask storm). Never auto-grabs the fs root."""
        p = tuple(parent)
        w = self._wbc_covering(p)
        if w is None and self.wbc_auto \
                and (self.wbc is None or not self.wbc.active) \
                and p != tuple(ROOT) and p not in self._wbc_denied:
            w = self._make_wbc(p)
            if w.acquire():
                self.wbc = w
            else:
                self._wbc_denied.add(p)
                w = None
        if w is not None and self.lmv.mdc_for_fid(p) is not w.mdc:
            # cross-MDT record: the batch reintegrates only at the
            # subtree root's MDS — not representable, go synchronous
            return None
        return w

    def _wbc_sync_guard(self, *fids):
        """A synchronous metadata write is about to touch the WBC
        subtree (an op the shadow cannot represent: rename, hard link,
        cross-MDT entries, dirs split into buckets). Flush pending
        records first — server-side order must match local order — and
        make the shadow re-learn the touched directories."""
        w = self.wbc
        if w is None or not w.active:
            return
        touched = [tuple(f) for f in fids if w.in_subtree(f)]
        if not touched:
            return
        self.sim.stats.count("wbc.fallback_sync")
        w.flush()
        for f in touched:
            w.forget(f)

    # ------------------------------------------------------------- files
    def creat(self, path: str, *, stripe_count: int = 0,
              stripe_size: int = 0, stripe_offset: int = -1,
              mode: int = 0o644, pattern: str = "raid0") -> FileHandle:
        """lstripe-style create with explicit striping (ch. 32.1).
        pattern "raid5" adds a rotating parity stripe (ch. 15)."""
        return self.open(path, "cwx", stripe_count=stripe_count,
                         stripe_size=stripe_size,
                         stripe_offset=stripe_offset, mode=mode,
                         pattern=pattern)

    def open(self, path: str, flags: str = "r", *, stripe_count: int = 0,
             stripe_size: int = 0, stripe_offset: int = -1,
             mode: int = 0o644, pattern: str = "raid0") -> FileHandle:
        """flags: r read, w write, c create, x exclusive."""
        parent, name = self._resolve_parent(path)
        w = self._wbc_for_write(parent) if "c" in flags \
            else self._wbc_covering(parent)
        if w is not None:
            fh = self._wbc_open(w, parent, name, flags, stripe_count,
                                stripe_size, stripe_offset, mode, path,
                                pattern)
            if fh is not None:
                return fh
        if "c" in flags:
            # the create may mutate the subtree behind the shadow's back
            self._wbc_sync_guard(parent)
        lk, data = self.lmv.open(parent, name, flags, mode)
        st = data.get("status", 0)
        if st:
            raise FsError(st, path)
        self._invalidate(parent, name)
        attrs = data["attrs"]
        fid = tuple(attrs["fid"])
        self._attr_drop(fid)       # open-for-write flips mtime_on_ost
        ea = data.get("ea", {})
        if data.get("created"):
            # client creates the data objects + writes the EA (§6.4.3)
            lsm = self.lov.create(
                stripe_count=stripe_count or self.default_stripe_count,
                stripe_size=stripe_size or self.default_stripe_size,
                stripe_offset=stripe_offset, pattern=pattern)
            self.lmv.mdc_for_fid(fid).reint(
                {"type": "setattr", "fid": fid, "ea": {"lov": lsm.to_ea()}})
        elif "lov" in ea:
            lsm = lov_mod.StripeMd.from_ea(ea["lov"])
        else:
            lsm = None
        fh = FileHandle(fid, lsm, data.get("open_handle", 0), flags)
        self.handles[id(fh)] = fh
        return fh

    def _wbc_open(self, w, parent, name, flags, stripe_count, stripe_size,
                  stripe_offset, mode, path,
                  pattern: str = "raid0") -> FileHandle | None:
        """Open/create under the WBC: shadow-born files open with zero
        RPCs, and a create lands in the cache — the client still creates
        the stripe objects itself (§6.4.3), the LOV EA rides the
        create's follow-up setattr record. Returns None to take the
        synchronous path (pre-existing inode, or a directory listing the
        shadow cannot own)."""
        handled, fid = w.child(parent, name)
        if not handled:
            return None
        if fid is not None:
            if "c" in flags and "x" in flags:
                raise FsError(-17, path)
            sa = w.attrs(fid)
            if sa is None:
                return None                # pre-existing inode: sync open
            if sa.get("type") == "dir":
                raise FsError(-21, path)
            ea = sa.get("ea") or {}
            lsm = lov_mod.StripeMd.from_ea(ea["lov"]) \
                if "lov" in ea else None
            self.sim.stats.count("wbc.open_local")
            fh = FileHandle(fid, lsm, 0, flags, wbc=True)
            self.handles[id(fh)] = fh
            return fh
        if "c" not in flags:
            raise FsError(-2, path)        # authoritative ENOENT
        fid = w.create(parent, name, "file", mode)
        lsm = self.lov.create(
            stripe_count=stripe_count or self.default_stripe_count,
            stripe_size=stripe_size or self.default_stripe_size,
            stripe_offset=stripe_offset, pattern=pattern)
        w.setattr(fid, ea={"lov": lsm.to_ea()})
        self._invalidate(parent, name)
        fh = FileHandle(fid, lsm, 0, flags, wbc=True)
        self.handles[id(fh)] = fh
        return fh

    def write(self, fh: FileHandle, data: bytes, offset: int | None = None,
              gid: int = 0) -> int:
        if fh.lsm is None:
            raise FsError(-22, "no stripe md")
        off = fh.pos if offset is None else offset
        n = self.lov.write(fh.lsm, off, data, gid=gid)
        fh.pos = off + n
        fh.max_written = max(fh.max_written, off + n)
        fh.mtime = self.sim.now
        self.sim.stats.add_bytes("fs.write", n)
        return n

    def read(self, fh: FileHandle, length: int,
             offset: int | None = None) -> bytes:
        if fh.lsm is None:
            raise FsError(-22, "no stripe md")
        off = fh.pos if offset is None else offset
        # PR-locked size query: flushes any writer's write-back cache
        # before we trust the OST sizes (§6.2.3 ordering); served from
        # the cached locks' value blocks when warm (zero RPCs)
        size = self.lov.getattr_locked(fh.lsm)["size"]
        length = max(0, min(length, size - off))
        if length == 0:
            return b""
        out = self.lov.read(fh.lsm, off, length)
        self._maybe_readahead(fh, off, len(out), size)
        fh.pos = off + len(out)
        self.sim.stats.add_bytes("fs.read", len(out))
        return out

    def _maybe_readahead(self, fh: FileHandle, off: int, nread: int,
                         size: int):
        """Per-handle sequential-read detector: a read starting exactly
        where the last one ended (or at 0 on a fresh handle) extends a
        readahead window that ramps up to `readahead_pages`, fetched
        stripe-aware into the OSC clean caches (one vectored OST_READ per
        stripe object). A seek resets the window."""
        ra_max = self.readahead_pages * osc_mod.PAGE_SIZE
        if ra_max <= 0:
            return
        if off != fh.ra_next:
            # seek: not sequential — back off, and forget the old fetch
            # horizon (a stale ra_pos ahead of a backward seek would
            # suppress refills for the whole re-scanned range; refetching
            # still-cached runs costs zero RPCs, readv skips them)
            fh.ra_window = 0
            fh.ra_pos = off + nread
            fh.ra_next = off + nread
            return
        fh.ra_next = off + nread
        fh.ra_window = min(ra_max, max(fh.ra_window * 2, ra_max // 4, 1))
        # hysteresis: refill only when less than half a window is still
        # ahead of the reader, and then fetch a FULL window — large
        # batched fetches, not a per-read top-up RPC
        ahead = fh.ra_pos - (off + nread)
        if ahead >= fh.ra_window // 2:
            return
        start = max(off + nread, fh.ra_pos)
        end = min(off + nread + fh.ra_window, size)
        if end > start:
            self.lov.readahead(fh.lsm, start, end - start)
            fh.ra_pos = end
            self.sim.stats.count("fs.readahead")
            self.sim.stats.add_bytes("fs.readahead", end - start)

    def _fsync_data(self, fh: FileHandle):
        if fh.lsm is not None:
            self.sim.parallel([
                (lambda u=u: self.lov.by_uuid[u].flush())
                for u in {o["ost"] for o in fh.lsm.objects}])

    def fsync(self, fh: FileHandle):
        """Flush the handle's dirty data — and, under WBC, reintegrate
        pending metadata too: fsync is a durability barrier, so the
        file's create/setattr records must reach the MDS (§17.2)."""
        self._fsync_data(fh)
        w = self._wbc_covering(fh.fid)
        if w is not None and w.records:
            self.sim.stats.count("wbc.fsync_barrier")
            w.flush()

    def close(self, fh: FileHandle):
        """Flush + ship size/mtime to the MDS (§6.9.1: the OSTs owned them
        while the file was open for write). A WBC handle's size/mtime
        land as a setattr record instead — close is not a reintegration
        point (ch. 17), fsync and release are."""
        self._fsync_data(fh)
        size = mtime = None
        if "w" in fh.flags or "c" in fh.flags:
            if fh.lsm is not None:
                a = self.lov.getattr(fh.lsm)
                size, mtime = a["size"], max(a["mtime"], fh.mtime)
        if fh.wbc:
            w = self._wbc_covering(fh.fid)
            if w is not None and w.attrs(fh.fid) is not None:
                if size is not None:
                    w.setattr(fh.fid, attrs={"size": size, "mtime": mtime})
            elif size is not None:
                # the cache died since the open: reintegrate size/mtime
                # synchronously (the create either flushed — fid exists —
                # or was lost with the lock: nothing left to update)
                try:
                    self.lmv.mdc_for_fid(fh.fid).reint(
                        {"type": "setattr", "fid": fh.fid,
                         "attrs": {"size": size, "mtime": mtime}})
                except R.RpcError:
                    self.sim.stats.count("wbc.orphan_close")
            self._attr_drop(fh.fid)
            self.handles.pop(id(fh), None)
            return
        self.lmv.close(fh.fid, fh.open_handle, size, mtime)
        self._attr_drop(fh.fid)    # size/mtime just moved to the MDS
        self.handles.pop(id(fh), None)

    # ------------------------------------------------------------- dirs
    def mkdir(self, path: str, mode: int = 0o755) -> tuple:
        parent, name = self._resolve_parent(path)
        w = self._wbc_for_write(parent)
        if w is not None:
            handled, fid = w.child(parent, name)
            if handled:
                if fid is not None:
                    raise FsError(-17, path)
                self._invalidate(parent, name)
                return w.create(parent, name, "dir", mode)
        self._wbc_sync_guard(parent)
        rep = self.lmv.reint({"type": "create", "parent": parent,
                              "name": name, "ftype": "dir", "mode": mode})
        self._invalidate(parent, name)
        return tuple(rep.data["fid"])

    def mkdir_p(self, path: str) -> tuple:
        fid = ROOT
        parts = self._parts(path)
        for i in range(len(parts)):
            sub = "/" + "/".join(parts[:i + 1])
            try:
                fid = self.resolve(sub)
            except FsError:
                fid = self.mkdir(sub)
        return tuple(fid)

    def readdir(self, path: str) -> dict:
        fid = self.resolve(path)
        w = self._wbc_covering(fid)
        if w is not None:
            listing = w.listing(fid)
            if listing is not None:
                # the shadow owns this listing: zero RPCs once seeded
                self.sim.stats.count("wbc.readdir_local")
                return {k: tuple(v) for k, v in listing.items()}
        out = {k: tuple(v)
               for k, v in self.lmv.readdir(fid)["entries"].items()}
        # the listing order seeds the statahead detector: stats walking
        # it sequentially will prefetch attr windows
        self._sa_record(fid, out.items())
        return out

    def _sa_record(self, dfid, order):
        """Install a directory's statahead detector, keeping only the
        most recently listed directories (a whole-namespace walk must
        not pin a (name, fid) listing per directory forever)."""
        self._sa.pop(tuple(dfid), None)
        self._sa[tuple(dfid)] = _Statahead(order)
        while len(self._sa) > 64:
            self._sa.pop(next(iter(self._sa)))

    def _absorb_page(self, dfid, mdc, lk, page):
        """Feed one readdir-plus page into the dentry + attr caches:
        every entry is covered by the page's dir/bucket PR lock. Attrs
        of entries whose inode a peer MDT owns (flagged `remote`) have
        no covering lock — they serve this pass only."""
        if lk is None:
            return
        dfid = tuple(dfid)
        for name, e in page.items():
            attrs = e.get("attrs")
            if attrs is None:
                continue
            fid = tuple(e["fid"])
            self.dcache[(dfid, name)] = Dentry(fid, dict(attrs),
                                               lk.handle, mdc)
            if not e.get("remote"):
                self._attr_put(fid, attrs, e.get("ea"), mdc, lk.handle)

    def _iter_plus(self, dfid):
        """readdir-plus iteration of ONE directory: yields (name, fid,
        attrs, ea) while absorbing pages into the caches and recording
        the statahead order."""
        order = []
        locks: list = []
        names: set = set()
        complete = True
        for mdc, lk, page in self.lmv.readdir_plus(dfid, self.dir_pages):
            self._absorb_page(dfid, mdc, lk, page)
            if lk is None:
                complete = False           # unlocked page: no window
            elif (mdc, lk.handle) not in locks:
                locks.append((mdc, lk.handle))
            for name, e in page.items():
                names.add(name)
                fid = tuple(e["fid"])
                attrs, ea = e.get("attrs"), e.get("ea") or {}
                if attrs is None:
                    # raced removal of a remote inode: sync fallback
                    try:
                        d = self.lmv.getattr(fid, want_ea=True)
                    except R.RpcError:
                        continue
                    attrs, ea = d["attrs"], d.get("ea", {})
                order.append((name, fid))
                yield name, fid, dict(attrs), ea
        self._sa_record(dfid, order)
        if complete:
            self._neg_install(tuple(dfid), locks, names)

    def ls_l(self, path: str) -> dict:
        """`ls -l`: name -> full stat attrs for every entry. With
        `dir_pages` set the listing is readdir-plus paged — attrs + LOV
        EAs ride the directory pages under the dir's PR lock, and the
        sizes of files under write are resolved with ONE batched glimpse
        per OST across ALL of them. dir_pages=0 keeps the seed shape
        (readdir + per-entry stat), still statahead-accelerated when
        statahead_max > 0."""
        wbc_owned = False
        if self.wbc is not None and self.wbc.active:
            try:
                f = self.resolve(path)
            except FsError:
                f = None
            wbc_owned = f is not None and self._wbc_covering(f) is not None \
                and self.wbc.listing(f) is not None
        if not self.dir_pages or wbc_owned:
            # shadow-owned dirs: a server-side readdir-plus would miss
            # the unflushed entries — list + stat through the shadow
            base = "/" + "/".join(self._parts(path))
            base = "" if base == "/" else base
            return {name: self.stat(f"{base}/{name}")
                    for name in self.readdir(path)}
        fid = self.resolve(path)
        out: dict[str, dict] = {}
        glimpse_lsm: dict[tuple, lov_mod.StripeMd] = {}
        glimpse_names: dict[tuple, list] = {}   # fid -> EVERY linked name
        for name, f, a, ea in self._iter_plus(fid):
            if a.get("mtime_on_ost") and "lov" in ea:
                glimpse_lsm[f] = lov_mod.StripeMd.from_ea(ea["lov"])
                glimpse_names.setdefault(f, []).append(name)
            if "lov" in ea:
                a["stripe_count"] = ea["lov"]["stripe_count"]
                a["stripe_size"] = ea["lov"]["stripe_size"]
            out[name] = a
        if glimpse_lsm:
            # size/mtime of files under write live on the OSTs (§6.9.1):
            # one vectored glimpse per OST covers every such file
            res = self.lov.glimpse_files(glimpse_lsm)
            for f, names in glimpse_names.items():
                g = res[f]
                for name in names:     # hard links share the one answer
                    out[name] = dict(out[name], size=g["size"],
                                     mtime=max(out[name]["mtime"],
                                               g["mtime"]))
        return out

    def walk(self):
        """Iterative whole-namespace walk (split-directory buckets
        included via the LMV): yields (parent_fid, name, fid, attrs) for
        every directory entry — the 'initial scan' primitive
        Robinhood-style consumers bootstrap from
        (tools.audit.ChangelogAuditor(bootstrap=True)). With `dir_pages`
        set it rides readdir-plus: attrs arrive WITH the directory pages
        (O(N/page) RPCs + one getattr_bulk per MDT per page for
        cross-MDT inodes), instead of one getattr per entry."""
        stack = [ROOT]
        seen = {ROOT}
        while stack:
            dfid = stack.pop()
            if self.dir_pages:
                for name, fid, attrs, _ in self._iter_plus(dfid):
                    yield tuple(dfid), name, fid, attrs
                    if attrs["type"] == "dir" and fid not in seen:
                        seen.add(fid)
                        stack.append(fid)
                continue
            for name, fid in self.lmv.readdir(dfid)["entries"].items():
                fid = tuple(fid)
                attrs = self.lmv.getattr(fid)["attrs"]
                yield tuple(dfid), name, fid, attrs
                if attrs["type"] == "dir" and fid not in seen:
                    seen.add(fid)
                    stack.append(fid)

    def symlink(self, target: str, path: str):
        parent, name = self._resolve_parent(path)
        w = self._wbc_for_write(parent)
        if w is not None:
            handled, fid = w.child(parent, name)
            if handled:
                if fid is not None:
                    raise FsError(-17, path)
                w.create(parent, name, "symlink", 0o777, target=target)
                self._invalidate(parent, name)
                return
        self._wbc_sync_guard(parent)
        self.lmv.reint({"type": "create", "parent": parent, "name": name,
                        "ftype": "symlink", "target": target})
        self._invalidate(parent, name)

    def link(self, existing: str, path: str):
        fid = self.resolve(existing)
        parent, name = self._resolve_parent(path)
        # hard links (possibly reaching out of the subtree) are not
        # representable in the shadow: flush + synchronous (ch. 17)
        self._wbc_sync_guard(fid, parent)
        self.lmv.reint({"type": "link", "parent": parent, "name": name,
                        "fid": fid})
        self._invalidate(parent, name)
        self._attr_drop(fid)       # its nlink just changed

    def rename(self, old: str, new: str):
        sp, sn = self._resolve_parent(old)
        dp, dn = self._resolve_parent(new)
        # renames can cross the subtree boundary or MDTs — not
        # representable in the shadow: flush + synchronous (ch. 17)
        self._wbc_sync_guard(sp, dp)
        rep = self.lmv.reint({"type": "rename", "src": sp, "src_name": sn,
                              "dst": dp, "dst_name": dn})
        self._invalidate(sp, sn)
        self._invalidate(dp, dn)
        # rename-over displaced the old target's last link: destroy its
        # data objects exactly as unlink does
        self._destroy_from_reply(rep)

    def unlink(self, path: str):
        parent, name = self._resolve_parent(path)
        w = self._wbc_for_write(parent)
        if w is not None:
            handled, fid = w.child(parent, name)
            if handled and fid is None:
                raise FsError(-2, path)     # authoritative ENOENT
            if handled and (sa := w.attrs(fid)) is not None:
                # shadow-born inode: the unlink is fully local
                if sa.get("type") == "dir" and w.listing(fid):
                    raise FsError(-39, path)
                w.unlink(parent, name)
                self._invalidate(parent, name)
                return
        # pre-existing inode (the MDS owns its nlink/emptiness checks
        # and hands back the EA for object destroys): synchronous
        self._wbc_sync_guard(parent)
        rep = self.lmv.reint({"type": "unlink", "parent": parent,
                              "name": name})
        self._invalidate(parent, name)
        self._destroy_from_reply(rep)

    rmdir = unlink

    def _destroy_from_reply(self, rep):
        self._destroy_from_data(rep.data or {})

    def _destroy_from_data(self, data: dict):
        """Last link gone (unlink or rename-over, synchronous or via a
        flushed WBC record): the LOV EA + llog cookies hand the object
        destroys to THE CLIENT; OSTs cancel the MDS records once their
        destroys commit (ch. 8.4)."""
        ea = data.get("ea") or {}
        if "lov" in ea:
            lsm = lov_mod.StripeMd.from_ea(ea["lov"])
            self.lov.destroy(lsm, data.get("cookies"))

    # -------------------------------------------------------- statahead
    def _sa_note_stat(self, dfid, name: str):
        """Statahead detector: a stat hitting the next entry of the last
        readdir order extends a sequential run; at run >= 2 the next
        window of entries' attrs is prefetched in batch (the metadata
        analogue of the sequential-read detector)."""
        st = self._sa.get(tuple(dfid))
        if st is None or self.statahead_max <= 0:
            return
        i = st.index.get(name)
        if i is None:
            return
        st.run = st.run + 1 if i == st.pos + 1 else 1
        st.pos = i
        if st.run >= 2 and i + 1 < len(st.order) \
                and st.fetched < i + 1 + self.statahead_max // 2:
            self._sa_prefetch(tuple(dfid), st, i + 1)

    def _sa_prefetch(self, dfid, st: _Statahead, lo: int):
        """Prefetch the next statahead window: ONE getattr_bulk per
        owning MDT (issued concurrently), then ONE vectored glimpse per
        OST for the fetched files whose size/mtime live on the OSTs.
        Attrs of entries the directory's PR lock covers land in the
        coherent attr cache; the rest (cross-MDT inodes, glimpses) are
        one-shot. An armed `mds.statahead` failpoint (drop/crash —
        client-side, crash degrades to drop) abandons the prefetch: the
        following stats simply stay synchronous."""
        hi = min(len(st.order), lo + self.statahead_max)
        lo = max(lo, st.fetched)
        window = [(n, tuple(f)) for n, f in st.order[lo:hi]
                  if self._attr_get(f) is None
                  and tuple(f) not in self._sa_attrs]
        if not window:
            st.fetched = max(st.fetched, hi)
            return
        act = fail_mod.state.check("mds.statahead")
        if act in ("drop", "crash"):
            self.sim.stats.count("fs.statahead_dropped")
            return
        dmdc = self.lmv.mdc_for_fid(dfid)
        lk = dmdc.locks.match(("fid", *tuple(dfid)), "PR")
        if lk is None:
            # one PR enqueue on the dir covers the whole pipeline: the
            # MDS revokes it on any namespace or child-attr change
            lk, _, _ = dmdc.locks.enqueue(("fid", *tuple(dfid)), "PR")
        by_mdc: dict = {}
        for n, f in window:
            by_mdc.setdefault(self.lmv.mdc_for_fid(f), []).append((n, f))

        def fetch(m, items):
            return m, items, m.getattr_bulk([f for _, f in items],
                                            want_ea=True)

        outs = self.sim.parallel([(lambda m=m, it=it: fetch(m, it))
                                  for m, it in by_mdc.items()])
        glimpse: dict = {}
        for m, items, attrs in outs:
            for (n, f), a in zip(items, attrs):
                if a is None:
                    continue
                if m is dmdc and lk is not None:
                    self._attr_put(f, a["attrs"], a.get("ea"),
                                   dmdc, lk.handle)
                    self.dcache[(tuple(dfid), n)] = Dentry(
                        f, dict(a["attrs"]), lk.handle, dmdc)
                else:
                    # no covering lock on the OWNING MDT — serve once,
                    # valid only while the dir lock the prefetch ran
                    # under survives (a remote setattr forwards its
                    # revocation to that lock via the inode's
                    # remote_pfids, killing this entry with it)
                    self._sa_attrs[f] = (dmdc, lk.handle if lk else None,
                                         a)
                ea = a.get("ea") or {}
                if a["attrs"].get("mtime_on_ost") and "lov" in ea:
                    glimpse[f] = lov_mod.StripeMd.from_ea(ea["lov"])
        if glimpse:
            for f, g in self.lov.glimpse_files(glimpse).items():
                self._sa_glimpse[f] = (dmdc, lk.handle if lk else None, g)
        st.fetched = max(st.fetched, hi)
        # one-shot results are disposable (an unconsumed entry just
        # costs a sync re-fetch): bound both pools
        if len(self._sa_attrs) > 4096:
            self._sa_attrs.clear()
        if len(self._sa_glimpse) > 4096:
            self._sa_glimpse.clear()
        self.sim.stats.count("fs.statahead")
        self.sim.stats.count("fs.statahead_entries", len(window))

    def _sa_pop(self, pool: dict, fid):
        """Consume a one-shot statahead result iff the dir lock it was
        prefetched under is STILL held — a revocation (including one
        forwarded cross-MDT) since the prefetch voids it."""
        e = pool.pop(tuple(fid), None)
        if e is None:
            return None
        mdc, handle, payload = e
        if handle is None or handle not in mdc.locks.locks:
            self.sim.stats.count("fs.statahead_stale_dropped")
            return None
        return payload

    # ------------------------------------------------------------- stat
    def stat(self, path: str) -> dict:
        parts = self._parts(path)
        fid = self.resolve(path)
        if self.wbc is not None and self.wbc.active:
            sa = self.wbc.attrs(fid)
            if sa is not None:
                # shadow-born inode: attrs live in the cache, zero RPCs
                self.sim.stats.count("wbc.stat_local")
                a = dict(sa)
                ea = dict(a.pop("ea", None) or {})
                if "lov" in ea:
                    a["stripe_count"] = ea["lov"]["stripe_count"]
                    a["stripe_size"] = ea["lov"]["stripe_size"]
                return a
        if parts:
            # statahead bookkeeping keyed by the parent as spelled in
            # the path (a symlinked parent just misses the detector)
            try:
                parent = self.resolve("/".join(parts[:-1])) \
                    if parts[:-1] else ROOT
                self._sa_note_stat(parent, parts[-1])
            except FsError:
                pass
        ca = self._attr_get(fid)
        if ca is not None:
            # warm path: the covering dir lock is still held — zero RPCs
            self.sim.stats.count("fs.attr_hit")
            a, ea = dict(ca.attrs), dict(ca.ea)
        else:
            one = self._sa_pop(self._sa_attrs, fid)
            if one is not None:
                self.sim.stats.count("fs.statahead_hit")
                a, ea = dict(one["attrs"]), dict(one.get("ea") or {})
            else:
                self.sim.stats.count("fs.attr_miss")
                d = self.lmv.getattr(fid, want_ea=True)
                a, ea = dict(d["attrs"]), dict(d.get("ea") or {})
        if a.get("mtime_on_ost") and "lov" in ea:
            # size/mtime live on the OSTs while a writer is active
            # (§6.9.1): a statahead-prefetched glimpse answers for free,
            # else one batched glimpse per OST (writers keep their locks)
            g = self._sa_pop(self._sa_glimpse, fid)
            if g is None:
                g = self.lov.glimpse(lov_mod.StripeMd.from_ea(ea["lov"]))
            a = dict(a, size=g["size"], mtime=max(a["mtime"], g["mtime"]))
        if "lov" in ea:
            a["stripe_count"] = ea["lov"]["stripe_count"]
            a["stripe_size"] = ea["lov"]["stripe_size"]
        return a

    def setattr(self, path: str, *, mode=None, uid=None, gid=None,
                mtime=None, size=None) -> dict:
        """mds_reint_setattr on the path's inode (chmod/chown/utimes/
        metadata truncate). The MDS revokes every directory PR lock
        covering cached copies of these attrs — ours included — so no
        client ever serves them stale."""
        fid = self.resolve(path)
        attrs = {k: v for k, v in (("mode", mode), ("uid", uid),
                                   ("gid", gid), ("mtime", mtime),
                                   ("size", size)) if v is not None}
        w = self.wbc
        if w is not None and w.active and w.attrs(fid) is not None:
            # shadow-born inode: the setattr is one more cache record
            w.setattr(fid, attrs=attrs)
            self._attr_drop(fid)
            return dict(w.attrs(fid))
        rep = self.lmv.reint({"type": "setattr", "fid": fid,
                              "attrs": attrs})
        self._attr_drop(fid)       # we changed them: our copy is stale
        return rep.data["attrs"]

    def chmod(self, path: str, mode: int) -> dict:
        return self.setattr(path, mode=mode)

    def truncate(self, path: str, size: int):
        """Truncate: punch the stripe objects, then setattr the MDS size
        (which revokes the attr-covering dir locks)."""
        fid = self.resolve(path)
        ca = self._attr_get(fid)
        if ca is not None:
            ea = dict(ca.ea)
        elif self.wbc is not None and self.wbc.active \
                and self.wbc.attrs(fid) is not None:
            ea = dict(self.wbc.attrs(fid).get("ea") or {})
        else:
            ea = self.lmv.getattr(fid, want_ea=True).get("ea", {})
        if "lov" in ea:
            self.lov.punch(lov_mod.StripeMd.from_ea(ea["lov"]), size)
        self.setattr(path, size=size, mtime=self.sim.now)

    def exists(self, path: str) -> bool:
        try:
            self.resolve(path)
            return True
        except FsError:
            return False

    # ------------------------------------------------------ raid5 rebuild
    def deactivate_ost(self, uuid: str):
        """`lctl --device deactivate`: mark an OST dead for this client —
        raid5 paths go degraded immediately instead of timing out."""
        self.lov.set_active(uuid, False)

    def activate_ost(self, uuid: str):
        self.lov.set_active(uuid, True)

    def rebuild_ost(self, dead_uuid: str, spare_uuid: str, *,
                    jobid: str = "rebuild",
                    limit: int | None = None) -> dict:
        """Background rebuilder (ch. 15): walk the namespace, and for
        every raid5 file striped over `dead_uuid` reconstruct the dead
        slot's object onto `spare_uuid` from survivors + parity, then
        swap the file's layout to the rebuilt object.

        * All reconstruction I/O is tagged with `jobid` so a ``tbf_orr``
          NRS rule ({"rebuild": rate}) throttles it server-side without
          starving client traffic.
        * The layout swap is a reint setattr on the LOV EA — the MDS
          applies it under its inode lock and revokes every attr-covering
          DLM lock, so readers re-fetch the EA atomically and never see
          a torn layout; a reader mid-degraded-read keeps using the OLD
          layout, which stays valid (the dead slot still reconstructs).
        * OBD_FAIL sites: ``lov.rebuild`` fires before each file's
          reconstruction, ``lov.layout_swap`` before each EA commit —
          both abort the walk with the old layout intact (crash-sweep
          proves no torn layouts / stale data either way).
        * ``limit`` caps the number of files rebuilt in this call (the
          batch-paced rebuild knob — callers interleave batches with
          foreground work; every file left behind still serves degraded
          reads and a later call resumes where the layouts say).
        """
        report = {"rebuilt": 0, "swapped": 0, "skipped": 0, "bytes": 0,
                  "aborted": False}
        spare = self.lov.by_uuid[spare_uuid]
        prev_jobid = self.rpc.jobid
        prev_active = self.lov.is_active(dead_uuid)
        self.set_jobid(jobid)
        self.lov.set_active(dead_uuid, False)
        try:
            for _, _, fid, attrs in self.walk():
                if attrs.get("type") != "file":
                    continue
                ea = self.lmv.getattr(fid, want_ea=True).get("ea") or {}
                if "lov" not in ea:
                    continue
                lsm = lov_mod.StripeMd.from_ea(ea["lov"])
                if lsm.pattern != "raid5" or not any(
                        o["ost"] == dead_uuid for o in lsm.objects):
                    report["skipped"] += 1
                    continue
                if fail_mod.state.check("lov.rebuild") in ("drop", "crash"):
                    # client-side site: the rebuilder dies mid-walk — no
                    # layout touched yet, a rerun finishes the job
                    self.sim.stats.count("lov.rebuild_aborted")
                    report["aborted"] = True
                    return report
                before = self.sim.stats.counters.get("lov.rebuild_bytes", 0)
                new_lsm = self.lov.rebuild_object(lsm, dead_uuid, spare)
                if new_lsm is None:
                    report["skipped"] += 1
                    continue
                report["rebuilt"] += 1
                report["bytes"] += \
                    self.sim.stats.counters.get("lov.rebuild_bytes", 0) \
                    - before
                if fail_mod.state.check("lov.layout_swap") in ("drop",
                                                               "crash"):
                    # abort BEFORE the EA commit: the old layout stays
                    # intact (still degraded-readable); the spare object
                    # is merely orphaned
                    self.sim.stats.count("lov.rebuild_aborted")
                    report["aborted"] = True
                    return report
                self.lmv.mdc_for_fid(fid).reint(
                    {"type": "setattr", "fid": fid,
                     "ea": {"lov": new_lsm.to_ea()}})
                self._attr_drop(fid)
                self.sim.stats.count("lov.layout_swap")
                report["swapped"] += 1
                if limit is not None and report["rebuilt"] >= limit:
                    break
        finally:
            self.set_jobid(prev_jobid)
            self.lov.set_active(dead_uuid, prev_active)
        return report

    # -------------------------------------------------- jobid / changelog
    def set_jobid(self, jobid: str):
        """Tag every subsequent RPC from this client with a batch-job id
        (the JOBENV model): the same tag drives TBF NRS classification on
        servers and attribution in changelog records."""
        self.rpc.jobid = jobid

    def changelog_register(self, *, mdt: int = 0) -> str:
        return self.lmv.mdcs[mdt].changelog_register()

    def changelog_deregister(self, user: str, *, mdt: int = 0):
        self.lmv.mdcs[mdt].changelog_deregister(user)

    def changelog_read(self, user: str, *, mdt: int = 0,
                       since_idx: int | None = None,
                       count: int = 0) -> list[dict]:
        return self.lmv.mdcs[mdt].changelog_read(user, since_idx, count)

    def changelog_clear(self, user: str, up_to: int, *,
                        mdt: int = 0) -> dict:
        return self.lmv.mdcs[mdt].changelog_clear(user, up_to)

    def statfs(self) -> dict:
        mds = self.lmv.statfs()
        osts = [o.statfs() for o in self.lov.oscs]
        return {"mds": mds,
                "capacity": sum(o["capacity"] for o in osts),
                "free": sum(o["free"] for o in osts),
                "objects": sum(o["objects"] for o in osts)}

    # ----------------------------------------------------- wbc lifecycle
    def enable_wbc(self, path: str) -> bool:
        """Enter metadata write-back mode for a subtree (ch. 17)."""
        fid = self.resolve(path)
        wbc = self._make_wbc(fid)
        if wbc.acquire():
            self.wbc = wbc
            return True
        return False

    def disable_wbc(self):
        if self.wbc:
            self.wbc.release()
            self.wbc = None

    def sync(self):
        if self.wbc:
            self.wbc.flush()
        self.lov.flush()
