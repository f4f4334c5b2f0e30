"""Snapshot logical OBD driver (paper §5.4).

A case study in logical object drivers: the snap device stacks on a direct
device whose volume holds *direct* objects and *redirector* objects. The
volume is characterised by snapshot times T1 < ... < Tk; attaching with
snapshot index S=0 gives the writable primary, S>0 a read-only clone.

COW per §5.4.1: the first write to an object after a snapshot time freezes
the current data into a new direct object and repoints the redirector slots
for the snapshots it belongs to.
"""
from __future__ import annotations

from repro_torch.core import obd as obd_mod


class SnapDevice(obd_mod.ObdDevice):
    obd_type = "snap"

    def __init__(self, name: str, bottom: obd_mod.FilterDevice,
                 snap_index: int = 0):
        super().__init__(name)
        self.bottom = bottom
        self.snap_index = snap_index
        # shared table on the bottom device so all attached snap devices
        # of one volume agree (the paper stores it in volume metadata)
        tbl = getattr(bottom, "_snap_table", None)
        if tbl is None:
            tbl = bottom._snap_table = {"times": [], "names": {}}
        self.table = tbl

    # ----------------------------------------------------------- admin
    def snap_add(self, name: str, time: float) -> int:
        """`snap add` — times may be 'written to current time' (§5.4)."""
        self.table["times"].append(time)
        idx = len(self.table["times"])
        self.table["names"][idx] = name
        return idx

    def snap_list(self):
        return [{"index": 0, "name": "current"}] + [
            {"index": i + 1, "name": self.table["names"].get(i + 1, ""),
             "time": t} for i, t in enumerate(self.table["times"])]

    def snap_del(self, index: int):
        """Remove a snapshot: drop redirector pointers via an iterator."""
        for (g, o), obj in list(self.bottom.objects.items()):
            redir = obj.attrs.get("snap_redirect")
            if redir and redir.get(index):
                tgt = redir.pop(index)
                if tgt and tgt not in redir.values() and tgt != obj.oid:
                    still = any(v == tgt for v in redir.values())
                    if not still:
                        try:
                            self.bottom.destroy(g, tgt)
                        except obd_mod.ObdError:
                            pass
        self.table["names"].pop(index, None)

    def snap_restore(self, index: int):
        """Roll the primary back to snapshot `index` (snap restore)."""
        for (g, o), obj in list(self.bottom.objects.items()):
            redir = obj.attrs.get("snap_redirect")
            if not redir:
                continue
            tgt = redir.get(index)
            if tgt:
                data = self.bottom.read(g, tgt, 0,
                                        self.bottom.getattr(g, tgt)["size"])
                cur = redir.get(0)
                if cur:
                    self.bottom.punch(g, cur, 0)
                    self.bottom.write(g, cur, 0, data)
                else:
                    obj.data = bytearray(data)

    # -------------------------------------------------------- redirection
    def _slot_for_read(self, obj) -> int | None:
        """Which direct object serves reads for this snap index (§5.4.1)."""
        redir = obj.attrs.get("snap_redirect")
        if redir is None:
            return None                      # direct object
        if self.snap_index == 0:
            return redir.get(0)
        # snapshot read: exact slot, else the object was not modified
        # since that snapshot -> current data (slot 0) is still correct
        return redir.get(self.snap_index, redir.get(0))

    def _cow(self, group: int, oid: int):
        """First write after a snapshot time: freeze current data."""
        obj = self.bottom._get(group, oid)
        times = self.table["times"]
        if not times:
            return
        t = obj.mtime
        k = len(times)
        # snapshots whose time >= mtime still reference the current data
        needs = [i + 1 for i, st in enumerate(times)
                 if st >= t and (obj.attrs.get("snap_redirect", {})
                                 .get(i + 1) is None)]
        if not needs:
            return
        redir = obj.attrs.setdefault("snap_redirect", {})
        cur = redir.get(0, oid)
        cur_obj = self.bottom._get(group, cur)
        frozen = self.bottom.create(group)["oid"]
        self.bottom.write(group, frozen, 0, bytes(cur_obj.data))
        self.bottom.setattr(group, frozen, snap_frozen=True)
        for i in needs:
            redir[i] = frozen
        if 0 not in redir:
            # turn `oid` into a redirector: its data moves to a new direct
            # object N; pointer 0 -> N (§5.4.1)
            n = self.bottom.create(group)["oid"]
            self.bottom.write(group, n, 0, bytes(cur_obj.data))
            redir[0] = n

    # ------------------------------------------------------------ obd api
    def _ro(self):
        if self.snap_index != 0:
            raise obd_mod.ObdError(30, "read-only snapshot")   # EROFS

    def create(self, group, oid=None, **attrs):
        self._ro()
        return self.bottom.create(group, oid, **attrs)

    def destroy(self, group, oid):
        self._ro()
        obj = self.bottom._get(group, oid)
        redir = obj.attrs.get("snap_redirect")
        if redir:
            # object still referenced by snapshots: just null the 0 slot
            tgt = redir.pop(0, None)
            if tgt and tgt != oid:
                self.bottom.destroy(group, tgt)
            return {"transno": 0}
        return self.bottom.destroy(group, oid)

    def getattr(self, group, oid):
        obj = self.bottom._get(group, oid)
        slot = self._slot_for_read(obj)
        if slot is None or slot == oid:
            return self.bottom.getattr(group, oid)
        a = self.bottom.getattr(group, slot)
        if self.snap_index == 0:
            a["mtime"] = obj.mtime
        return a

    def setattr(self, group, oid, **attrs):
        self._ro()
        self._cow(group, oid)
        return self.bottom.setattr(group, oid, **attrs)

    def read(self, group, oid, offset, length):
        obj = self.bottom._get(group, oid)
        slot = self._slot_for_read(obj)
        if slot is None or slot == oid:
            return self.bottom.read(group, oid, offset, length)
        return self.bottom.read(group, slot, offset, length)

    def write(self, group, oid, offset, data, **kw):
        self._ro()
        self._cow(group, oid)
        obj = self.bottom._get(group, oid)
        redir = obj.attrs.get("snap_redirect")
        tgt = redir[0] if redir and 0 in redir else oid
        out = self.bottom.write(group, tgt, offset, data, **kw)
        obj.mtime = max(obj.mtime, kw.get("mtime", 0.0)) or obj.mtime
        return out

    def punch(self, group, oid, size):
        self._ro()
        self._cow(group, oid)
        obj = self.bottom._get(group, oid)
        redir = obj.attrs.get("snap_redirect")
        tgt = redir[0] if redir and 0 in redir else oid
        return self.bottom.punch(group, tgt, size)

    def statfs(self):
        return self.bottom.statfs()

    def list_objects(self, group):
        return [o for o in self.bottom.list_objects(group)
                if not self.bottom._get(group, o).attrs.get("snap_frozen")]
