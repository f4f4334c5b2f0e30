"""Global namespace: mount-objects + automounter (paper ch. 3).

Per the paper's design (§3.4): a mount-object is an ORDINARY directory
with the setuid bit set, containing a `mntinfo` file whose content names
the target fileset ("fileset://name[@cell]"). Traversal INTO the
directory (not mere lookup OF it — the anti-mount-storm rule) triggers
the automounter, which grafts the target fileset's root into the path
walk. Mount-objects survive in the underlying fs as plain directories, so
they can be created/removed with standard APIs — the property the paper
argues for against AFS symlink magic.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.fsio.client import FsError, LustreClient

SETUID = 0o4000


class Automounter:
    """The fileset-location "database" + mount cache (§3.6).

    `filesets` maps "fileset://name" -> a callable returning a mounted
    LustreClient (lazy: filesets may live on other clusters)."""

    def __init__(self):
        self.filesets: dict[str, Callable[[], LustreClient]] = {}
        self.mounted: dict[str, LustreClient] = {}
        self.mounts = 0

    def register(self, uri: str, factory: Callable[[], LustreClient]):
        self.filesets[uri] = factory

    def mount(self, uri: str) -> LustreClient:
        fs = self.mounted.get(uri)
        if fs is None:
            if uri not in self.filesets:
                raise FsError(-2, f"unknown fileset {uri}")
            fs = self.mounted[uri] = self.filesets[uri]()
            self.mounts += 1
        return fs

    def expire(self, uri: str):
        """Release an idle fileset (autofs-style expiry)."""
        self.mounted.pop(uri, None)


def make_mount_object(fs: LustreClient, path: str, uri: str):
    """Create a mount-object: setuid directory + mntinfo file (§3.4)."""
    fid = fs.mkdir_p(path)
    fs.lmv.reint({"type": "setattr", "fid": fid,
                  "attrs": {"mode": 0o755 | SETUID}})
    fh = fs.creat(path.rstrip("/") + "/mntinfo", stripe_count=1)
    fs.write(fh, uri.encode())
    fs.close(fh)
    return fid


class GlobalNamespace:
    """Wraps a LustreClient with mount-object traversal."""

    def __init__(self, root_fs: LustreClient, automounter: Automounter):
        self.root_fs = root_fs
        self.amd = automounter

    def _resolve_fs(self, path: str) -> tuple[LustreClient, str]:
        """Walk from the root fs, following mount-objects; returns the
        filesystem owning the final component + the path within it."""
        fs = self.root_fs
        parts = [p for p in path.split("/") if p]
        i = 0
        base = []
        while i < len(parts):
            base.append(parts[i])
            sub = "/".join(base)
            try:
                st = fs.stat(sub)
            except FsError:
                break
            if st["type"] == "dir" and (st["mode"] & SETUID) \
                    and i + 1 <= len(parts):
                # traversal INTO the mount-object (or opendir) mounts it;
                # a bare stat of the object itself must NOT (§3.3).
                if i + 1 == len(parts):
                    break
                fh = fs.open(sub + "/mntinfo")
                uri = fs.read(fh, 4096).decode()
                fs.close(fh)
                fs = self.amd.mount(uri)
                parts = parts[i + 1:]
                base = []
                i = 0
                continue
            i += 1
        return fs, "/" + "/".join(parts)

    # --------------------------------------------------- forwarded ops
    def stat(self, path: str) -> dict:
        fs, p = self._resolve_fs(path)
        return fs.stat(p)

    def open(self, path: str, flags: str = "r", **kw):
        fs, p = self._resolve_fs(path)
        return fs, fs.open(p, flags, **kw)

    def readdir(self, path: str) -> dict:
        fs, p = self._resolve_fs(path)
        return fs.readdir(p)

    def read_file(self, path: str, length: int = 1 << 30) -> bytes:
        fs, fh = self.open(path)
        data = fs.read(fh, length)
        fs.close(fh)
        return data
