"""Distributed striped checkpointing over the Lustre substrate.

The checkpoint manager of `repro.ckpt.checkpoint`, with the same design
and the same bytes on disk:

  * one file per leaf of the state tree, `step_%08d/<leaf>.bin`, striped
    over OSTs and written by N LustreClients in parallel under group
    locks (ch. 10.10), after a metadata burst under a WBC subtree lock;
  * crash consistency: data files first, MANIFEST.json last (the commit
    record); `restore` trusts only steps with a manifest and
    `cleanup_incomplete` removes the others;
  * erasure coding: an XOR parity file per leaf (`.parity`, placed by
    `_parity_ost`), computed by the port's parity kernel on `device`;
    `restore` rebuilds one stripe object lost to a dead OST's disk,
    reading the surviving objects and the parity in BRW-RPC-sized pieces
    (the reference reads each in one RPC, which times out on large
    leaves: `_read_object`);
  * elastic restore: the manifest keeps shapes and dtypes.

Leaves may be torch tensors or numpy arrays; a tensor on the card comes
to the host once (`.detach().cpu()`).  numpy has no bfloat16, so a
bfloat16 tensor is stored by its raw bytes under the dtype name
"bfloat16", as the reference stores its bfloat16 arrays, and is restored
as a bfloat16 tensor.  Every other leaf is restored as a numpy array.

The manager calls only client methods and this package's LOV helpers,
so it also runs on the reference package's clients (with an explicit
`device`): a checkpoint written by either package restores in the other.
"""
from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from repro_torch.core.osc import PAGE_SIZE
from repro_torch.fsio.client import FsError, LustreClient
from repro_torch.kernels import ops as kops

BF16 = "bfloat16"


def _leaf_paths(tree, prefix=()):
    """Stable (path, leaf) list: dict keys sorted, sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (str(i),))
    else:
        yield ".".join(prefix), tree


def _unflatten(skeleton, values: dict):
    if isinstance(skeleton, dict):
        return {k: _unflatten(v, values[k]) for k, v in skeleton.items()}
    return skeleton, values


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array and its manifest dtype name.  A bfloat16
    tensor becomes an int16 view of its bytes named "bfloat16"."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _quant_int8(arr: np.ndarray, block: int = 256):
    """Blockwise symmetric int8: q = round(x / s), s = absmax/127 per
    block (the error-feedback-free storage variant of adamw.compress)."""
    flat = arr.astype(np.float32).ravel()
    n = len(flat)
    pad = (-n) % block
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, block)
    scales = (np.abs(blocks).max(axis=1) / 127.0 + 1e-12).astype(np.float32)
    q = np.clip(np.round(blocks / scales[:, None]), -127, 127).astype(
        np.int8)
    return q.ravel()[:n + pad], scales, block


def _dequant_int8(data: bytes, entry: dict) -> np.ndarray:
    qm = entry["quant"]
    ns, blk = qm["n_scales"], qm["block"]
    scales = np.frombuffer(data[:ns * 4], np.float32)
    q = np.frombuffer(data[ns * 4:], np.int8).astype(np.float32)
    out = (q.reshape(-1, blk) * scales[:, None]).ravel()
    n = int(np.prod(entry["shape"]))
    return out[:n].astype(qm["orig_dtype"]).reshape(entry["shape"])


def _decode(data: bytes, entry: dict):
    """A leaf's stored bytes -> numpy array (a bfloat16 tensor for
    "bfloat16")."""
    if entry.get("quant"):
        return _dequant_int8(data, entry)
    if entry["dtype"] == BF16:
        return torch.frombuffer(bytearray(data), dtype=torch.bfloat16
                                ).reshape(entry["shape"])
    return np.frombuffer(data, entry["dtype"]).reshape(entry["shape"])


# A stripe object or a single-stripe file is read by the reference in
# one RPC, whose transfer outlasts the RPC timeout once it passes a few
# tens of MB, so its rebuild of a large leaf fails (ROADMAP R9).  Past one
# BRW RPC's pages the port reads such bytes in RPC-sized pieces; up to it,
# in the reference's one call.

def _rpc_bytes(osc) -> int:
    return osc.max_pages_per_rpc * PAGE_SIZE


def _read_object(osc, o: dict, size: int) -> bytes:
    """A surviving stripe object, whole."""
    rpc = _rpc_bytes(osc)
    if size <= rpc:
        return osc.read(o["group"], o["oid"], 0, size)
    return b"".join(osc.readv(o["group"], o["oid"], [
        (off, min(rpc, size - off)) for off in range(0, size, rpc)]))


def _read_parity(fs, path: str, size: int) -> bytes:
    """A leaf's parity file (one stripe) of `size` bytes, whole."""
    fh = fs.open(path)
    rpc = _rpc_bytes(fs.lov.oscs[0])
    if size <= rpc:
        par = fs.read(fh, 1 << 30)
    else:
        par = b"".join(fs.read(fh, min(rpc, size - off), offset=off)
                       for off in range(0, size, rpc))
    fs.close(fh)
    return par


class CheckpointManager:
    def __init__(self, clients: list[LustreClient], base: str = "/ckpt",
                 *, stripe_count: int = 0, stripe_size: int = 1 << 20,
                 parity: bool = False, use_wbc: bool = True,
                 quantize: str | None = None, device=None):
        """`clients` = parallel writer hosts (>=1). parity=True adds an
        erasure stripe per tensor file, computed on `device` (default:
        the cluster's).  quantize="int8" stores float tensors as
        blockwise int8 + f32 scales (4x less wire/disk; lossy - meant for
        high-frequency intermediate checkpoints)."""
        self.clients = clients
        self.fs = clients[0]
        self.sim = self.fs.sim
        self.base = base.rstrip("/")
        self.stripe_count = stripe_count
        self.stripe_size = stripe_size
        self.parity = parity
        self.use_wbc = use_wbc
        self.quantize = quantize
        self.device = kops.resolve_device(
            self.fs.cluster.device if device is None else device)
        self.fs.mkdir_p(self.base)

    # -------------------------------------------------------------- save
    def _step_dir(self, step: int) -> str:
        return f"{self.base}/step_{step:08d}"

    def save(self, step: int, tree: Any, *, extra_meta: dict | None = None
             ) -> dict:
        """Write one checkpoint. Returns the manifest.  Each leaf comes to
        the host when its writer takes it, so one leaf's host copy is
        alive at a time."""
        leaves = list(_leaf_paths(tree))
        d = self._step_dir(step)
        # overwrite semantics: a re-save of the same step (two trainers
        # resumed from one checkpoint) replaces the old content
        if self.fs.exists(d):
            for f in sorted(self.fs.readdir(d)):
                try:
                    self.fs.unlink(f"{d}/{f}")
                except FsError:
                    pass
        # metadata burst: create the step dir + files under a WBC subtree
        # lock when the MDS grants one (ch. 17)
        self.fs.mkdir_p(d)
        if self.use_wbc:
            self.fs.enable_wbc(d)
        manifest = {"step": step, "leaves": {}, **(extra_meta or {})}

        def write_leaf(w_idx: int, name: str, leaf):
            fs = self.clients[w_idx % len(self.clients)]
            arr, dtype = _host(leaf)
            qmeta = None
            if self.quantize == "int8" and arr.dtype.kind == "f" \
                    and arr.size >= 256:
                q, scales, blk = _quant_int8(arr)
                data = scales.tobytes() + q.tobytes()
                qmeta = {"block": blk, "n_scales": len(scales),
                         "orig_dtype": dtype}
            else:
                data = arr.tobytes()
            fh = fs.creat(f"{d}/{name}.bin",
                          stripe_count=self.stripe_count,
                          stripe_size=self.stripe_size)
            fs.write(fh, data, gid=1 + w_idx)       # group locks (ch.10.10)
            fs.close(fh)
            entry = {"shape": list(arr.shape), "dtype": dtype,
                     "bytes": len(data), "writer": w_idx % len(self.clients)}
            if qmeta:
                entry["quant"] = qmeta
            if self.parity and len(data) > 0:
                p = self._parity_for(fh, data)
                pfh = fs.creat(f"{d}/{name}.parity",
                               stripe_count=1,
                               stripe_offset=self._parity_ost(fh))
                fs.write(pfh, p, gid=1 + w_idx)
                fs.close(pfh)
                entry["parity"] = True
            return name, entry

        if self.use_wbc:
            self.fs.disable_wbc()      # flush the metadata batch first
        outs = self.sim.parallel([
            (lambda i=i, n=n, v=v: write_leaf(i, n, v))
            for i, (n, v) in enumerate(leaves)])
        for name, entry in outs:
            manifest["leaves"][name] = entry
        for fs in self.clients:
            fs.sync()
        # commit record LAST: a manifest present == checkpoint complete
        mdata = json.dumps(manifest).encode()
        fh = self.fs.creat(f"{d}/MANIFEST.json", stripe_count=1)
        self.fs.write(fh, mdata)
        self.fs.close(fh)
        self.fs.sync()
        for t in self.fs.cluster.ost_targets:       # durable commit point
            t.commit()
        self.sim.stats.count("ckpt.saved")
        return manifest

    def _parity_for(self, fh, data: bytes) -> bytes:
        """XOR parity across the file's stripe columns (the parity
        kernel, one launch)."""
        lsm = fh.lsm
        ssz, cnt = lsm.stripe_size, lsm.stripe_count
        if cnt < 2:
            return kops.parity_bytes([data], device=self.device)
        view = memoryview(data)           # the columns without copies
        cols = [view[i * ssz:(i + 1) * ssz]
                for i in range(-(-len(data) // ssz))]
        rows = [b"".join(cols[i::cnt]) for i in range(cnt)]
        rows = [r for r in rows if r]
        return kops.parity_bytes(rows, device=self.device)

    @staticmethod
    def _parity_ost(fh) -> int:
        """Place parity on an OST not holding any data stripe if possible."""
        lsm = fh.lsm
        return (lsm.stripe_offset + lsm.stripe_count) % max(
            1, len(fh.lsm.objects) + 1)

    # ------------------------------------------------------------ restore
    def steps(self) -> list[int]:
        try:
            names = self.fs.readdir(self.base)
        except FsError:
            return []
        out = []
        for n in names:
            if n.startswith("step_"):
                s = int(n.split("_")[1])
                if self.fs.exists(f"{self.base}/{n}/MANIFEST.json"):
                    out.append(s)
        return sorted(out)

    def latest(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int | None = None) -> tuple[dict, dict]:
        """Returns ({leaf_name: np.ndarray, or a bfloat16 tensor},
        manifest). Reads leaves in parallel across reader clients;
        reconstructs stripes lost to dead OSTs from parity when
        enabled."""
        if step is None:
            step = self.latest()
        if step is None:
            raise FsError(-2, "no complete checkpoint")
        d = self._step_dir(step)
        fh = self.fs.open(f"{d}/MANIFEST.json")
        manifest = json.loads(self.fs.read(fh, 1 << 24))
        self.fs.close(fh)
        names = sorted(manifest["leaves"])

        def read_leaf(i: int, name: str):
            fs = self.clients[i % len(self.clients)]
            e = manifest["leaves"][name]
            try:
                fh = fs.open(f"{d}/{name}.bin")
                data = fs.read(fh, e["bytes"])
                fs.close(fh)
                if len(data) != e["bytes"]:
                    raise FsError(-5, "short read")
            except Exception:       # the reference's client raises its own
                if not e.get("parity"):
                    raise
                data = self._reconstruct(fs, d, name, e)
            return name, _decode(data, e)

        outs = self.sim.parallel([
            (lambda i=i, n=n: read_leaf(i, n))
            for i, n in enumerate(names)])
        self.sim.stats.count("ckpt.restored")
        return dict(outs), manifest

    def _reconstruct(self, fs: LustreClient, d: str, name: str,
                     e: dict) -> bytes:
        """One stripe object is gone (dead OST disk): rebuild it from the
        surviving stripes + parity (ch. 15; the parity kernel, one
        launch)."""
        from repro_torch.core import lov as lov_mod
        meta = fs.lmv.getattr(fs.resolve(f"{d}/{name}.bin"), want_ea=True)
        lsm = lov_mod.StripeMd.from_ea(meta["ea"]["lov"])
        ssz, cnt = lsm.stripe_size, lsm.stripe_count
        total = e["bytes"]
        rows: list[bytes | None] = []
        missing = None
        for i, o in enumerate(lsm.objects):
            try:
                osc = fs.lov.by_uuid[o["ost"]]
                sz = lov_mod.Lov._obj_size_for(lsm, i, total)
                rows.append(_read_object(osc, o, sz))
            except Exception:
                if missing is not None:
                    raise FsError(-5, "more than one stripe lost")
                missing = i
                rows.append(None)
        # the parity is as long as the longest row (stripe 0's object)
        par = _read_parity(fs, f"{d}/{name}.parity", max(
            lov_mod.Lov._obj_size_for(lsm, i, total)
            for i in range(len(lsm.objects))))
        if missing is not None:
            surv = [r for r in rows if r is not None]
            want = lov_mod.Lov._obj_size_for(lsm, missing, total)
            rows[missing] = kops.reconstruct_bytes(
                [r.ljust(len(par), b"\0") for r in surv],
                par, len(par), device=self.device)[:want]
            self.sim.stats.count("ckpt.stripe_reconstructed")
        # interleave stripe rows back into the logical byte stream
        out = bytearray(total)
        for i, row in enumerate(rows):
            for j in range(0, len(row), ssz):
                snum = (j // ssz) * cnt + i
                lpos = snum * ssz
                chunk = row[j:j + ssz]
                out[lpos:lpos + len(chunk)] = chunk[:max(0, total - lpos)]
        return bytes(out)

    # ----------------------------------------------------------- cleanup
    def cleanup_incomplete(self) -> list[str]:
        """Remove step dirs without a manifest (writer died mid-save)."""
        removed = []
        try:
            names = self.fs.readdir(self.base)
        except FsError:
            return removed
        for n in sorted(names):
            if not n.startswith("step_"):
                continue
            d = f"{self.base}/{n}"
            if self.fs.exists(f"{d}/MANIFEST.json"):
                continue
            for f in sorted(self.fs.readdir(d)):
                try:
                    self.fs.unlink(f"{d}/{f}")
                except FsError:
                    pass
            self.fs.rmdir(d)
            removed.append(n)
            self.sim.stats.count("ckpt.incomplete_removed")
        return removed

    def retain(self, keep: int = 3):
        """Delete old complete checkpoints beyond `keep`."""
        for s in self.steps()[:-keep]:
            d = self._step_dir(s)
            for f in sorted(self.fs.readdir(d)):
                self.fs.unlink(f"{d}/{f}")
            self.fs.rmdir(d)
