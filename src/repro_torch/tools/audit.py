"""Robinhood-style changelog auditor (arXiv:1505.02656, arXiv:2302.14824).

Consumes the per-MDT changelog streams of a (possibly striped-namespace)
cluster and maintains an out-of-band **namespace mirror** — the core trick
of Lustre activity-tracking tools: after an initial scan (here: starting
from an empty filesystem), the mirror stays in sync by applying changelog
records only, never re-walking the namespace. `verify()` then proves the
mirror equals the client-visible `readdir`/`stat` ground truth.

Stream merge across MDTs: each MDT's changelog is totally ordered by its
record index; across MDTs the virtual timestamp orders records (ties
broken by (mdt, idx)). Cross-MDT operations appear twice — a nameless
inode-half record on the remote MDT (``extra.remote``) and the
name-bearing record on the coordinator — so the mirror applies namespace
structure from coordinator records only and skips remote halves.

Usage:
    aud = ChangelogAuditor(client)      # registers on ALL MDTs
    ... workload ...
    aud.tail()                          # pull + merge + apply + clear
    report = aud.verify()               # mirror vs readdir/stat truth
    assert report["ok"]
"""
from __future__ import annotations

from repro_torch.core import changelog as cl_mod
from repro_torch.core.mds import ROOT_FID


class NamespaceMirror:
    """A shadow namespace rebuilt purely from changelog records.

    Tracks, per inode fid: type, the set of (parent fid, name) links, and
    size/mode when SETATTR/CLOSE records supplied them. The mirror does
    its own link accounting — a file node dies when its last link is
    removed — so UNLINK records need no "last link" hint (though the MDS
    provides one when it knows)."""

    def __init__(self):
        self.nodes: dict[tuple, dict] = {
            ROOT_FID: {"type": "dir", "links": set()}}
        self.children: dict[tuple, dict] = {ROOT_FID: {}}
        self.applied = 0
        self.skipped_remote = 0

    # ------------------------------------------------------------ helpers
    def _add_node(self, fid: tuple, ftype: str):
        node = self.nodes.setdefault(fid, {"type": ftype, "links": set()})
        if ftype == "dir":
            self.children.setdefault(fid, {})
        return node

    def _add_link(self, fid: tuple, pfid: tuple, name: str):
        old = self.children.get(pfid, {}).get(name)
        if old is not None and old != fid:
            self._unlink_name(pfid, name)      # displace the old entry
        self.nodes[fid]["links"].add((pfid, name))
        self.children.setdefault(pfid, {})[name] = fid

    def _unlink_name(self, pfid: tuple, name: str):
        old = self.children.get(pfid, {}).pop(name, None)
        if old is None:
            return
        node = self.nodes.get(old)
        if node is None:
            return
        node["links"].discard((pfid, name))
        if not node["links"]:
            self.nodes.pop(old, None)
            self.children.pop(old, None)

    # -------------------------------------------------------------- apply
    def apply(self, rec: dict):
        """Apply one wire-format record (`ChangelogRecord.to_wire`)."""
        extra = rec.get("extra") or {}
        if extra.get("remote"):
            # inode half of a cross-MDT op; the coordinator's name-bearing
            # record carries the namespace change
            self.skipped_remote += 1
            return
        t = rec["type"]
        fid = tuple(rec["fid"]) if rec.get("fid") else None
        pfid = tuple(rec["pfid"]) if rec.get("pfid") else None
        name = rec.get("name", "")
        if t in (cl_mod.CL_CREAT, cl_mod.CL_MKDIR, cl_mod.CL_SYMLINK):
            ftype = {cl_mod.CL_CREAT: "file", cl_mod.CL_MKDIR: "dir",
                     cl_mod.CL_SYMLINK: "symlink"}[t]
            node = self._add_node(fid, ftype)
            if "mode" in extra:
                node["mode"] = extra["mode"]
            self._add_link(fid, pfid, name)
        elif t == cl_mod.CL_LINK:
            self._add_node(fid, self.nodes.get(fid, {}).get("type", "file"))
            self._add_link(fid, pfid, name)
        elif t in (cl_mod.CL_UNLINK, cl_mod.CL_RMDIR):
            self._unlink_name(pfid, name)
        elif t == cl_mod.CL_RENAME:
            spfid = tuple(extra["spfid"])
            self._unlink_name_keep(spfid, extra["sname"])
            self._add_node(fid, self.nodes.get(fid, {}).get("type", "file"))
            self._add_link(fid, pfid, name)
        elif t == cl_mod.CL_SETATTR:
            node = self.nodes.get(fid)
            if node is not None:
                attrs = extra.get("attrs", {})
                for k in ("mode", "uid", "gid", "size"):
                    if k in attrs:
                        node[k] = attrs[k]
        elif t == cl_mod.CL_CLOSE:
            node = self.nodes.get(fid)
            if node is not None:
                node["size"] = extra.get("size", node.get("size"))
        self.applied += 1

    def _unlink_name_keep(self, pfid: tuple, name: str):
        """Remove a directory entry WITHOUT killing the node (rename
        source side: the inode moves, it does not die)."""
        old = self.children.get(pfid, {}).pop(name, None)
        if old is not None and old in self.nodes:
            self.nodes[old]["links"].discard((pfid, name))


class ChangelogAuditor:
    """Tails the changelogs of ALL MDTs behind one client mount, merging
    the per-MDT streams by timestamp into a single ordered activity feed
    that drives a NamespaceMirror."""

    def __init__(self, client, bootstrap: bool = False):
        self.client = client
        self.lmv = client.lmv
        self.mirror = NamespaceMirror()
        self.feed: list[dict] = []          # merged, ordered activity
        self.users: dict[int, str] = {}     # mdt idx -> consumer id
        self.applied_idx: dict[int, int] = {}
        for i, mdc in enumerate(self.lmv.mdcs):
            self.users[i] = mdc.changelog_register()
            self.applied_idx[i] = 0
        if bootstrap:
            self.bootstrap_scan()

    # ---------------------------------------------------------- bootstrap
    def bootstrap_scan(self):
        """Initial scan of an already-populated namespace (the Robinhood
        bootstrap): consumers are registered FIRST (above), so everything
        that changes during the walk is recorded; the walk then loads the
        readdir/getattr ground truth into the mirror; the closing tail()
        replays whatever raced the scan — record application is
        idempotent against already-scanned state (links are sets, entry
        inserts displace)."""
        for pfid, name, fid, attrs in self.client.walk():
            node = self.mirror._add_node(fid, attrs["type"])
            if attrs.get("mode") is not None:
                node["mode"] = attrs["mode"]
            if attrs["type"] == "file" and not attrs.get("mtime_on_ost"):
                node["size"] = attrs["size"]
            self.mirror._add_link(fid, pfid, name)
        self.tail()

    # --------------------------------------------------------------- tail
    def tail(self, clear: bool = True) -> int:
        """Pull new records from every MDT, merge by (time, mdt, idx),
        apply to the mirror, and (by default) acknowledge them. Returns
        the number of records applied."""
        batch = []
        for i, mdc in enumerate(self.lmv.mdcs):
            for rec in mdc.changelog_read(self.users[i],
                                          since_idx=self.applied_idx[i]):
                batch.append((rec.get("time", 0.0), i, rec["idx"], rec))
        batch.sort(key=lambda t: t[:3])
        for time_, mdt, idx, rec in batch:
            self.mirror.apply(rec)
            self.feed.append(dict(rec, mdt=mdt))
            self.applied_idx[mdt] = max(self.applied_idx[mdt], idx)
        if clear:
            # only ack MDTs that contributed to THIS batch — an idle MDT
            # gets no redundant clear RPC (and no server-side purge scan)
            for mdt in sorted({m for _, m, _, _ in batch}):
                self.lmv.mdcs[mdt].changelog_clear(
                    self.users[mdt], self.applied_idx[mdt])
        return len(batch)

    def close(self):
        for i, mdc in enumerate(self.lmv.mdcs):
            mdc.changelog_deregister(self.users[i])
        self.users.clear()

    # ------------------------------------------------------------- verify
    def verify(self) -> dict:
        """Walk the real namespace (client-visible readdir/stat ground
        truth, split-directory buckets included) and diff it against the
        mirror. Returns {"ok", "mismatches", "dirs", "entries"}."""
        mism = []
        reachable = {ROOT_FID}
        stack = [ROOT_FID]
        seen = {ROOT_FID}
        n_dirs = n_entries = 0
        while stack:
            dfid = stack.pop()
            n_dirs += 1
            out = self.lmv.readdir(dfid)
            truth = {k: tuple(v) for k, v in out["entries"].items()}
            mine = dict(self.mirror.children.get(dfid, {}))
            if truth != mine:
                mism.append({"kind": "entries", "dir": dfid,
                             "truth": truth, "mirror": mine})
            for name, fid in truth.items():
                n_entries += 1
                reachable.add(fid)
                attrs = self.lmv.getattr(fid)["attrs"]
                node = self.mirror.nodes.get(fid)
                if node is None:
                    mism.append({"kind": "missing", "fid": fid,
                                 "name": name})
                    continue
                if node["type"] != attrs["type"]:
                    mism.append({"kind": "type", "fid": fid, "name": name,
                                 "truth": attrs["type"],
                                 "mirror": node["type"]})
                if (attrs["type"] == "file" and "size" in node
                        and not attrs.get("mtime_on_ost")
                        and node["size"] != attrs["size"]):
                    mism.append({"kind": "size", "fid": fid, "name": name,
                                 "truth": attrs["size"],
                                 "mirror": node["size"]})
                if attrs["type"] == "dir" and fid not in seen:
                    seen.add(fid)
                    stack.append(fid)
        for fid in set(self.mirror.nodes) - reachable:
            mism.append({"kind": "extra", "fid": fid,
                         "mirror": self.mirror.nodes[fid]})
        return {"ok": not mism, "mismatches": mism,
                "dirs": n_dirs, "entries": n_entries}
