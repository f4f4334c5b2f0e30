"""Per-MDT changelog: a persistent stream of metadata activity.

Layered on the llog machinery (paper ch. 8) exactly like the unlink log:
every namespace update the MDS executes appends one typed record to a
per-MDT `LlogCatalog` *inside the same transaction/undo scope as the
operation itself* — a crashed (rolled-back) reint retracts its record, a
replayed reint re-emits it, so consumers see each committed operation
exactly once.

The consumer model follows Doreau's *Distributed Lustre activity
tracking* (arXiv:1505.02656) and the Robinhood policy engine it feeds:

  * recording is active only while at least one consumer is registered
    (``changelog_register`` -> "cl1", "cl2", ...);
  * each consumer owns a persistent *bookmark* — the highest record index
    it has acknowledged via ``changelog_clear``.  Bookmarks are
    **journaled with the catalog header**: register/clear/deregister run
    as transactions whose undo restores the previous header state, so a
    crash mid-clear rolls bookmark AND purge back together (never one
    without the other), and a committed clear survives MDS restart —
    the consumer resumes at its journaled bookmark with no re-delivery
    of cleared records;
  * records are purged from the catalog only past the MINIMUM bookmark
    across all registered consumers: a slow auditor pins the stream, a
    fast one never destroys data someone else still needs;
  * **changelog_gc**: a consumer that stays idle past a configurable
    record lag (``gc_max_idle_indexes``) or virtual-time lag
    (``gc_max_idle_time``) is garbage-collected — deregistered by the
    MDS — so a dead consumer cannot pin the stream forever (real Lustre
    grew the same knobs);
  * ``changelog_read(user, since_idx)`` returns retained records above an
    index, so multiple independent consumers (HSM, audit, mirror) tail
    the same stream;
  * a record handed to a consumer must be durable — not just locally
    (journal commit before serving an uncommitted tail) but *cluster*
    durable: the MDS serves only records at or below the cluster-committed
    consistent cut (mds._gate_at_cluster_cut), so not even a multi-MDT
    consistent-cut rollback (recovery.py §6.7.6.3) can retract a record
    a consumer has seen.

Records carry (fid, parent fid, name, timestamp, client uuid, jobid) so
audit tooling (arXiv:2302.14824) can answer "who did what, where, when,
and for which batch job" — the jobid is the same tag the TBF NRS policy
classifies on (core.nrs), threaded through `ptlrpc.Request`.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

from repro_torch.core import fail as fail_mod
from repro_torch.core import llog as llog_mod

# Record types (the CL_* subset our MDS emits).
CL_CREAT = "CREAT"        # regular file create
CL_MKDIR = "MKDIR"
CL_SYMLINK = "SYMLINK"
CL_UNLINK = "UNLINK"
CL_RMDIR = "RMDIR"
CL_RENAME = "RENAME"
CL_LINK = "LINK"
CL_SETATTR = "SETATTR"
CL_CLOSE = "CLOSE"

CL_TYPES = (CL_CREAT, CL_MKDIR, CL_SYMLINK, CL_UNLINK, CL_RMDIR,
            CL_RENAME, CL_LINK, CL_SETATTR, CL_CLOSE)


@dataclasses.dataclass
class ChangelogRecord:
    idx: int                  # per-MDT, strictly increasing (gaps allowed:
                              # a rolled-back record's index is not reused)
    cl_type: str
    fid: tuple | None         # inode the operation applied to
    pfid: tuple | None        # parent directory (name-bearing ops)
    name: str                 # entry name under pfid ("" for inode ops)
    time: float               # virtual timestamp (merge key across MDTs)
    client: str               # originating client uuid
    jobid: str                # batch-job tag (see core.nrs TBF rules)
    extra: dict = dataclasses.field(default_factory=dict)
    transno: int = 0          # owning transaction (server-internal: the
                              # MDS commits it before serving the record)

    def to_wire(self) -> dict:
        d = {"idx": self.idx, "type": self.cl_type, "fid": self.fid,
             "pfid": self.pfid, "name": self.name, "time": self.time,
             "client": self.client, "jobid": self.jobid}
        if self.extra:
            d["extra"] = dict(self.extra)
        return d


class Changelog:
    """One MDT's changelog catalog + journaled consumer header.

    `txn` is the owning target's transaction hook (undo registration):
    consumer-header updates (register/clear/deregister) go through it so
    they are crash-atomic with the purge they imply. `now` supplies the
    virtual time used for per-consumer idle tracking (changelog_gc).
    """

    def __init__(self, owner_uuid: str,
                 txn: Optional[Callable] = None,
                 now: Optional[Callable[[], float]] = None):
        self.owner_uuid = owner_uuid
        self.catalog = llog_mod.LlogCatalog(f"{owner_uuid}-changelog")
        self.users: dict[str, int] = {}      # consumer id -> bookmark idx
        self.user_time: dict[str, float] = {}    # id -> last activity
        self._user_seq = itertools.count(1)
        self._idx = itertools.count(1)
        self.last_idx = 0
        self.purged_to = 0
        self._cookies: dict[int, int] = {}   # record idx -> llog cookie
        self._txn = txn or (lambda undo: 0)
        self._now = now or (lambda: 0.0)
        # changelog_gc knobs (None = off); surfaced through lctl/procfs
        self.gc_max_idle_indexes: int | None = None
        self.gc_max_idle_time: float | None = None
        self.gc_collected: list[str] = []

    # --------------------------------------------------------- consumers
    @property
    def active(self) -> bool:
        """Recording is on only while someone is listening (the register
        RPC is what 'turns on' the changelog, as in real Lustre)."""
        return bool(self.users)

    def touch(self, uid: str):
        self.user_time[uid] = self._now()

    def register(self) -> str:
        uid = f"cl{next(self._user_seq)}"
        # a new consumer can read everything still retained; the header
        # update is a transaction so a crash before commit forgets the
        # consumer instead of resurrecting half of one
        self.users[uid] = self.purged_to
        self.touch(uid)

        def undo():
            self.users.pop(uid, None)
            self.user_time.pop(uid, None)
        self._txn(undo)
        return uid

    def deregister(self, uid: str):
        if uid not in self.users:
            raise KeyError(uid)
        bookmark = self.users.pop(uid)
        last_t = self.user_time.pop(uid, 0.0)
        restore_purge = self._purge()

        def undo():
            restore_purge()
            self.users[uid] = bookmark
            self.user_time[uid] = last_t
        self._txn(undo)

    # -------------------------------------------------------------- gc
    def maybe_gc(self):
        """Run the idle sweep iff any knob is set. Callers that stamp an
        owning transno into the next record must run this BEFORE
        computing it — each collected consumer's deregister is its own
        header transaction and consumes a transno."""
        if self.gc_max_idle_indexes is not None \
                or self.gc_max_idle_time is not None:
            self.gc()

    def gc(self) -> list[str]:
        """Garbage-collect idle consumers: a bookmark lagging more than
        `gc_max_idle_indexes` records behind the head, or a consumer
        silent for longer than `gc_max_idle_time` virtual seconds, is
        deregistered (its pin on the stream released). Returns the ids
        collected by this pass."""
        now = self._now()
        doomed = []
        for uid, bookmark in self.users.items():
            if (self.gc_max_idle_indexes is not None
                    and self.last_idx - bookmark > self.gc_max_idle_indexes):
                doomed.append(uid)
            elif (self.gc_max_idle_time is not None
                    and now - self.user_time.get(uid, 0.0)
                    > self.gc_max_idle_time):
                doomed.append(uid)
        for uid in doomed:
            self.deregister(uid)
            # the collected-ids bookkeeping rolls back with the
            # deregister: a crash must not report a still-registered
            # consumer as collected
            self.gc_collected.append(uid)

            def undo(uid=uid):
                if uid in self.gc_collected:
                    self.gc_collected.remove(uid)
            self._txn(undo)
        return doomed

    # ------------------------------------------------------------ record
    def emit(self, cl_type: str, fid, *, pfid=None, name: str = "",
             time: float = 0.0, client: str = "", jobid: str = "",
             transno: int = 0, **extra) -> ChangelogRecord | None:
        """Append one record; returns None while no consumer is
        registered. The CALLER's transaction undo must call `retract`
        on the returned record so aborted operations leave no trace.
        (The caller also runs `maybe_gc` first — see mds._cl — so the
        record's owning transno is computed after any GC transactions.)"""
        if not self.users:
            return None
        idx = next(self._idx)
        self.last_idx = idx
        rec = ChangelogRecord(idx, cl_type,
                              tuple(fid) if fid is not None else None,
                              tuple(pfid) if pfid is not None else None,
                              name, time, client, jobid, dict(extra),
                              transno)
        lrec = self.catalog.add("changelog", {"rec": rec})
        self._cookies[idx] = lrec.cookie
        fail_mod.note("mds.changelog.emit")
        return rec

    def retract(self, rec: ChangelogRecord | None):
        """Transaction rollback: remove an uncommitted record (no-op if it
        was already purged by a consumer that read past it)."""
        if rec is None:
            return
        cookie = self._cookies.pop(rec.idx, None)
        if cookie is not None:
            self.catalog.cancel([cookie])

    # ------------------------------------------------------------- read
    def records(self) -> list[ChangelogRecord]:
        # sorted by idx: appends keep order naturally, but a rolled-back
        # purge restores its records at the catalog tail
        return sorted((r.payload["rec"] for r in self.catalog.pending()),
                      key=lambda r: r.idx)

    def read(self, since_idx: int = 0, count: int = 0) \
            -> list[ChangelogRecord]:
        recs = [r for r in self.records() if r.idx > since_idx]
        return recs[:count] if count else recs

    def clear(self, uid: str, up_to: int):
        """Acknowledge records up to `up_to` for one consumer; physically
        purge only past the minimum bookmark across ALL consumers. The
        bookmark update and the purge are ONE transaction: its undo
        restores both, so a crash before the journal commit can never
        advance the bookmark while resurrecting the records (or vice
        versa)."""
        if uid not in self.users:
            raise KeyError(uid)
        old = self.users[uid]
        self.users[uid] = max(old, min(up_to, self.last_idx))
        self.touch(uid)
        restore_purge = self._purge()

        def undo():
            restore_purge()
            self.users[uid] = old
        self._txn(undo)

    def _purge(self) -> Callable[[], None]:
        """Purge past the min bookmark; returns the restore closure the
        caller journals as (part of) its transaction undo."""
        keep_after = min(self.users.values()) if self.users else self.last_idx
        doomed = [lrec for lrec in self.catalog.pending()
                  if lrec.payload["rec"].idx <= keep_after]
        removed_cookies = {}
        for lrec in doomed:
            idx = lrec.payload["rec"].idx
            removed_cookies[idx] = self._cookies.pop(idx, None)
        if doomed:
            self.catalog.cancel([lrec.cookie for lrec in doomed])
        old_purged = self.purged_to
        self.purged_to = max(self.purged_to, keep_after)

        def restore():
            self.purged_to = old_purged
            if doomed:
                self.catalog.restore(doomed)
            self._cookies.update({i: c for i, c in removed_cookies.items()
                                  if c is not None})
        return restore

    # ------------------------------------------------------------ procfs
    def info(self) -> dict:
        return {"active": self.active,
                "users": dict(self.users),
                "records": len(self.catalog.pending()),
                "last_idx": self.last_idx,
                "purged_to": self.purged_to,
                "plain_logs": len(self.catalog.logs),
                "gc": {"max_idle_indexes": self.gc_max_idle_indexes,
                       "max_idle_time": self.gc_max_idle_time,
                       "collected": list(self.gc_collected)}}
