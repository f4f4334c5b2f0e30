"""Object-Based Devices: class driver + direct drivers (paper ch. 5, 25).

The OBD *class driver* keeps a registry of attached devices by name/UUID
(the paper's `obdcontrol attach/setup` flow). Devices expose the object API:

    create destroy getattr setattr read write punch statfs sync

*Direct* drivers manage persistent storage (here: in-memory object store
with transactional undo, standing in for the ext2/filter backends).
*Logical* drivers (LOV striping, SNAP snapshots, COBD caching) stack on
other OBD devices through the same API — the paper's key structural idea.

Object ids: (group, oid) per the NSIC object-group extension the paper
argues for (§5.2.3) — snapshots and recovery both exploit groups. `create`
accepts a *requested* oid (§5.2.3: needed to migrate filesystems by moving
objects); the drive errors if it exists.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

from repro_torch.core import llog as llog_mod


class ObdError(Exception):
    def __init__(self, errno: int, msg: str = ""):
        super().__init__(f"obd error {errno}: {msg}")
        self.errno = errno


# ------------------------------------------------------------ class driver

class ObdClassDriver:
    """Device registry (one per cluster)."""

    def __init__(self):
        self.devices: dict[str, "ObdDevice"] = {}
        self.types: dict[str, type] = {}

    def register_type(self, name: str, cls: type):
        self.types[name] = cls

    def attach(self, type_name: str, name: str, *args, **kw) -> "ObdDevice":
        dev = self.types[type_name](name, *args, **kw)
        self.devices[name] = dev
        return dev

    def get(self, name: str) -> "ObdDevice":
        return self.devices[name]


class ObdDevice:
    """Abstract object device (method table of §25.2)."""

    obd_type = "abstract"

    def __init__(self, name: str):
        self.name = name

    # object API — direct/logical drivers override
    def create(self, group: int, oid: int | None = None, **attrs): ...
    def destroy(self, group: int, oid: int): ...
    def getattr(self, group: int, oid: int) -> dict: ...
    def setattr(self, group: int, oid: int, **attrs): ...
    def read(self, group: int, oid: int, offset: int, length: int) -> bytes: ...
    def write(self, group: int, oid: int, offset: int, data: bytes): ...
    def punch(self, group: int, oid: int, size: int): ...
    def statfs(self) -> dict: ...
    def sync(self): ...
    def list_objects(self, group: int) -> list: ...


# ------------------------------------------------------------------ filter

@dataclasses.dataclass
class StorageObject:
    oid: int
    group: int
    data: bytearray = dataclasses.field(default_factory=bytearray)
    attrs: dict = dataclasses.field(default_factory=dict)
    mtime: float = 0.0

    @property
    def size(self) -> int:
        return len(self.data)


class FilterDevice(ObdDevice):
    """Direct driver: the `obdfilter` stand-in. The OST's block allocation
    happens *here*, on the server — the paper's distributed-allocation
    insight (§2.2).

    Transactions: every update registers an undo closure with the owning
    target (set via `txn_hook`) so an OST crash rolls back to the last
    commit; clients then replay (ch. 11/29)."""

    obd_type = "filter"

    def __init__(self, name: str, capacity: int = 1 << 40):
        super().__init__(name)
        self.objects: dict[tuple[int, int], StorageObject] = {}
        self.capacity = capacity
        self.used = 0
        self._oid_seq = itertools.count(2)
        self.txn_hook = None             # set by OST: records undo closures
        self.llogs: dict[str, llog_mod.LlogCatalog] = {}

    def _txn(self, undo):
        if self.txn_hook:
            return self.txn_hook(undo)
        return 0

    def llog(self, name: str) -> llog_mod.LlogCatalog:
        cat = self.llogs.get(name)
        if cat is None:
            cat = self.llogs[name] = llog_mod.LlogCatalog(
                f"{self.name}:{name}")
        return cat

    # ----------------------------------------------------------- obd api
    def create(self, group: int, oid: int | None = None, **attrs):
        if oid is None:
            oid = next(self._oid_seq)
        key = (group, oid)
        if key in self.objects:
            raise ObdError(17, f"object {key} exists")      # EEXIST
        obj = StorageObject(oid=oid, group=group, attrs=dict(attrs))
        self.objects[key] = obj
        transno = self._txn(lambda: self.objects.pop(key, None))
        return {"group": group, "oid": oid, "transno": transno}

    def destroy(self, group: int, oid: int):
        key = (group, oid)
        obj = self.objects.pop(key, None)
        if obj is None:
            raise ObdError(2, f"no object {key}")            # ENOENT
        self.used -= obj.size
        sz = obj.size

        def undo():
            self.objects[key] = obj
            self.used += sz
        return {"transno": self._txn(undo)}

    def _get(self, group: int, oid: int) -> StorageObject:
        obj = self.objects.get((group, oid))
        if obj is None:
            raise ObdError(2, f"no object {(group, oid)}")
        return obj

    def getattr(self, group: int, oid: int) -> dict:
        obj = self._get(group, oid)
        return {"size": obj.size, "mtime": obj.mtime,
                "blocks": (obj.size + 4095) // 4096, **obj.attrs}

    def setattr(self, group: int, oid: int, **attrs):
        obj = self._get(group, oid)
        old = dict(obj.attrs)
        old_mtime = obj.mtime
        if "mtime" in attrs:
            obj.mtime = attrs.pop("mtime")
        obj.attrs.update(attrs)

        def undo():
            obj.attrs = old
            obj.mtime = old_mtime
        return {"transno": self._txn(undo)}

    def read(self, group: int, oid: int, offset: int, length: int) -> bytes:
        obj = self._get(group, oid)
        return bytes(obj.data[offset:offset + length])

    def write(self, group: int, oid: int, offset: int, data: bytes,
              mtime: float = 0.0):
        obj = self._get(group, oid)
        end = offset + len(data)
        if end - obj.size > self.capacity - self.used:
            raise ObdError(28, "no space")                   # ENOSPC
        old_len = obj.size
        overlap = bytes(obj.data[offset:min(end, old_len)])
        old_mtime = obj.mtime
        if end > old_len:
            self.used += end - old_len
            obj.data.extend(b"\0" * (end - old_len))
        obj.data[offset:end] = data
        obj.mtime = max(obj.mtime, mtime)
        grew = max(0, end - old_len)

        def undo():
            if grew:
                del obj.data[old_len:]
                self.used -= grew
            obj.data[offset:offset + len(overlap)] = overlap
            obj.mtime = old_mtime
        return {"transno": self._txn(undo), "size": obj.size}

    def writev(self, group: int, oid: int, iov: list, mtime: float = 0.0):
        """Apply a whole niobuf vector [(offset, data), ...] as ONE
        transaction (§4.5.6: bulk moves vectors of niobufs; the OST's BRW
        handler commits them under a single transno / single undo record).
        """
        obj = self._get(group, oid)
        old_len = obj.size
        max_end = max((off + len(d) for off, d in iov), default=old_len)
        if max_end - old_len > self.capacity - self.used:
            raise ObdError(28, "no space")                   # ENOSPC
        undos = []
        for off, data in iov:
            end = off + len(data)
            overlap = bytes(obj.data[off:min(end, obj.size)])
            if end > obj.size:
                self.used += end - obj.size
                obj.data.extend(b"\0" * (end - obj.size))
            obj.data[off:end] = data
            undos.append((off, overlap))
        grew = obj.size - old_len
        old_mtime = obj.mtime
        obj.mtime = max(obj.mtime, mtime)

        def undo():
            for off, overlap in reversed(undos):
                obj.data[off:off + len(overlap)] = overlap
            if grew:
                del obj.data[old_len:]
                self.used -= grew
            obj.mtime = old_mtime
        return {"transno": self._txn(undo), "size": obj.size}

    def punch(self, group: int, oid: int, size: int):
        """Truncate to `size`."""
        obj = self._get(group, oid)
        if size >= obj.size:
            return {"transno": 0}
        cut = bytes(obj.data[size:])
        del obj.data[size:]
        self.used -= len(cut)

        def undo():
            obj.data.extend(cut)
            self.used += len(cut)
        return {"transno": self._txn(undo)}

    def statfs(self) -> dict:
        return {"capacity": self.capacity, "used": self.used,
                "free": self.capacity - self.used,
                "objects": len(self.objects)}

    def sync(self):
        pass

    def list_objects(self, group: int) -> list:
        return sorted(o for g, o in self.objects if g == group)
