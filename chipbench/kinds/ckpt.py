"""Checkpoint cycles of one FSDP rank's training state through the
simulated store: save step n with parity (the XOR kernel, one launch a
leaf), lose the data objects of step n's leaves on one OST (a dead disk),
restore the latest checkpoint (each leaf with an object there rebuilt
from its survivors and parity on the card), then `retain(keep)`.  A unit
is one such cycle; its bytes are the state's, saved and restored (parity
excluded), and it records the seconds of its save and of its restore.

Checked after the window, exactly (every limit is 0):
  restore_diff  leaves of every restore in the window that differ from
                the state saved, byte for byte (or that are missing);
  parity_diff   parity files of the checkpoints still kept that differ
                from a NumPy XOR of their leaf's stripe columns;
  rebuild_miss  restores in which no lost object was rebuilt.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from chipbench import count, ref, weights
from chipbench import models as bench_models
from chipbench.ref import store as ref_store


def shard_leaves(cfg: dict, defs) -> list:
    """[(path, shard shape, kind)]: the leaves the rank holds, each sliced
    1/ranks along its largest dimension that `ranks` divides."""
    from repro_torch.models import layers as L
    sh = cfg["shard"]
    ranks = sh["fsdp_ranks"]
    out = []
    for path, d in L.tree_items(defs):
        if path[0] not in sh["leaves"]:
            continue
        shape = list(d.shape)
        dims = [i for i, n in enumerate(shape) if n % ranks == 0]
        if dims:
            i = max(dims, key=lambda j: (shape[j], -j))
            shape[i] //= ranks
        out.append((path, tuple(shape), d.init))
    return out


class Job:
    unit_name = "ckpt"

    def __init__(self, cell, seed: int, device, quantize=None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.quantize = quantize
        self.restores: list = []
        self.rebuilt: list = []

    def setup(self):
        from repro_torch.ckpt import CheckpointManager
        from repro_torch.core.cluster import LustreCluster
        from repro_torch.fsio import LustreClient
        from repro_torch.models import registry
        cfg, t = self.cell.config, self.cell.traffic
        defs = registry.param_defs(bench_models.model_config(cfg))
        leaves = shard_leaves(cfg, defs)
        params = weights.make(leaves, cfg.get("init", []), torch.float32,
                              self.seed, self.device)
        m = weights.make(leaves, [["*", "normal", 1e-3]], torch.float32,
                         self.seed + 1, self.device)
        v = weights.make(leaves, [["*", "normal", 1e-4]], torch.float32,
                         self.seed + 2, self.device)
        for _, leaf in ref.flat(v):
            leaf.abs_()
        self.state = {"params": params, "opt": {"m": m, "v": v}}
        self.cluster = LustreCluster(
            osts=t["osts"], ost_failover=t["ost_failover"],
            clients=t["clients"], max_cached_mb=t["max_cached_mb"],
            device=self.device)
        writers = [LustreClient(self.cluster, i % t["clients"]).mount()
                   for i in range(t["writers"])]
        self.fs = writers[0]
        self.mgr = CheckpointManager(
            writers, "/ckpt", parity=t["parity"],
            stripe_count=t["stripe_count"], stripe_size=t["stripe_size"],
            quantize=self.quantize)
        self.bytes = sum(leaf.numel() * leaf.element_size()
                         for _, leaf in ref.flat(self.state))
        self.step = 0
        self.unit(0)                  # the kernel loaded, the store warm
        self.restores.clear()
        self.rebuilt.clear()

    def _tree(self, step: int) -> dict:
        return {**self.state, "opt": {**self.state["opt"],
                                      "step": np.int64(step)}}

    def save(self) -> list:
        """Save the next step; the XOR launches it made, as (K, lanes)."""
        self.step += 1
        manifest = self.mgr.save(self.step, self._tree(self.step))
        calls = []
        t = self.cell.traffic
        for e in manifest["leaves"].values():
            if e.get("parity"):
                rows = count.stripe_rows(e["bytes"], t["stripe_size"],
                                         t["stripe_count"])
                calls.append((len(rows), count.xor_lanes(max(rows))))
        return calls

    def lose(self) -> None:
        """The data objects of the latest step's leaves on the lost OST
        are gone (a dead disk); its parity files and manifest stay."""
        t = self.cell.traffic
        d = f"/ckpt/step_{self.step:08d}"
        tgt = next(x for x in self.cluster.ost_targets
                   if x.uuid == t["lost_ost"])
        self.lost = []
        for name in self.fs.readdir(d):
            if not name.endswith(".bin"):
                continue
            ea = self.fs.lmv.getattr(self.fs.resolve(f"{d}/{name}"),
                                     want_ea=True)["ea"]["lov"]
            for o in ea["objects"]:
                if o["ost"] == tgt.uuid and \
                        tgt.obd.objects.pop((o["group"], o["oid"]), None) \
                        is not None:
                    self.lost.append(name)

    def restore(self) -> list:
        """Restore the latest step; the rebuilds' XOR launches."""
        before = self.cluster.stats.counters.get(
            "ckpt.stripe_reconstructed", 0)
        flat, manifest = self.mgr.restore()
        rebuilt = self.cluster.stats.counters.get(
            "ckpt.stripe_reconstructed", 0) - before
        self.restores.append((manifest["step"], flat))
        self.rebuilt.append(rebuilt)
        t = self.cell.traffic
        calls = []
        for name in self.lost:
            e = manifest["leaves"][name[:-4]]
            rows = count.stripe_rows(e["bytes"], t["stripe_size"],
                                     t["stripe_count"])
            calls.append((len(rows), count.xor_lanes(max(rows))))
        self.mgr.retain(keep=t["keep"])
        return calls

    def unit(self, i: int) -> dict:
        t0 = time.perf_counter()
        calls = self.save()
        self.lose()
        t1 = time.perf_counter()
        calls += self.restore()
        return {"bytes": 2 * self.bytes, "save_s": t1 - t0,
                "restore_s": time.perf_counter() - t1, "xor": calls}

    def end_to_end(self, units: list, window_s: float) -> dict:
        return {"ckpt_GBps": sum(u["bytes"] for u in units) / window_s / 1e9}

    def release(self):
        pass

    def check(self, units: list) -> dict:
        host = {name: leaf.detach().cpu().numpy()
                for name, leaf in ref.flat(self.state)}
        diff = 0
        for step, flat in self.restores:
            want = dict(host, **{"opt.step": np.int64(step)})
            if set(flat) != set(want):
                diff += len(set(flat) ^ set(want))
            for name in set(flat) & set(want):
                got = np.asarray(flat[name])
                if got.dtype != want[name].dtype or got.shape != np.shape(
                        want[name]) or got.tobytes() != np.asarray(
                        want[name]).tobytes():
                    diff += 1
        t = self.cell.traffic
        parity = 0
        for step in self.mgr.steps():
            want = dict(host, **{"opt.step": np.int64(step)})
            for name, arr in want.items():
                data = np.ascontiguousarray(arr).tobytes()
                path = f"/ckpt/step_{step:08d}/{name}.parity"
                want_p = ref_store.parity(data, t["stripe_size"],
                                          t["stripe_count"])
                fh = self.fs.open(path)
                got = b"".join(self.fs.read(fh, 1 << 20, offset=off)
                               for off in range(0, len(want_p) + 1, 1 << 20))
                self.fs.close(fh)
                if got != want_p:
                    parity += 1
        return {"restore_diff": float(diff), "parity_diff": float(parity),
                "rebuild_miss": float(sum(1 for r in self.rebuilt
                                          if r == 0))}
