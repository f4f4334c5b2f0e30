"""The raid5 section of `BENCH_rpc.json`, measured on the port.

Same scenario as the reference benchmark (`benchmarks/bench_parity.py`,
`raid5_metrics`), which imports JAX and so cannot drive the port:

  * a cold clean read and a cold degraded read (OST0001 failed and
    admin-deactivated) of a 768 KiB raid5 file at 64 KiB stripes,
    3 data + 1 parity, with their OST_READ RPCs and virtual times;
  * the rebuild of the dead OST onto the spare through `lctl`;
  * client p99 while a rebuild runs: no rebuild, a rebuild under the
    two-level tbf_orr throttle, and an unthrottled FIFO rebuild.

Every number is a count or a virtual time of the simulator, so the port
must reproduce the reference exactly on any device.

    PYTHONPATH=src python -m repro_torch.tools.raid5_metrics --device cpu
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core import LustreCluster
from repro_torch.core.metrics import merge_jobid_histograms
from repro_torch.fsio import LustreClient


def _payload(n: int, seed: int = 5) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(1, 256, n, dtype=np.uint8).tobytes()


def _cold_reads_and_rebuild(device) -> dict:
    out: dict = {}
    size, ssz = 768 << 10, 64 << 10
    data = _payload(size)
    c = LustreCluster(osts=4, mdses=1, clients=3, spare_osts=1,
                      commit_interval=256, device=device)
    fs = LustreClient(c, 0).mount()
    fh = fs.creat("/f", stripe_count=3, stripe_size=ssz,
                  stripe_offset=0, pattern="raid5")
    fs.write(fh, data, offset=0)
    fs.close(fh)
    for t in c.ost_targets:
        t.commit()

    def cold_read(idx, degraded):
        r = LustreClient(c, idx).mount()
        if degraded:
            r.deactivate_ost("OST0001")
        rpc0 = c.stats.counters.get("rpc.ost.read", 0)
        t0 = c.now
        f = r.open("/f")
        got = r.read(f, size, offset=0)
        r.close(f)
        return {"identical": got == data,
                "vtime_s": round(c.now - t0, 6),
                "ost_read_rpcs":
                    c.stats.counters.get("rpc.ost.read", 0) - rpc0}

    out["clean"] = cold_read(1, degraded=False)
    c.fail_node("ost1")
    out["degraded"] = cold_read(2, degraded=True)
    out["degraded"]["overhead_x"] = round(
        out["degraded"]["vtime_s"] / max(1e-9, out["clean"]["vtime_s"]), 2)
    out["degraded"]["reconstructed_units"] = \
        c.stats.counters.get("lov.reconstruct_unit", 0)

    # a fresh maintenance client (cold caches), so the reconstruction
    # reads really cross the wire
    t0 = c.now
    rep = c.lctl("rebuild", "OST0001", c.spare_uuids[0])
    rb_vt = c.now - t0
    out["rebuild"] = {
        "files": rep["rebuilt"], "bytes": rep["bytes"],
        "layout_swaps": rep["swapped"],
        "vtime_s": round(rb_vt, 6),
        "throughput_MBps": round(rep["bytes"] / max(1e-9, rb_vt) / 1e6, 2),
    }
    return out


def _p99_during_rebuild(mode: str, device) -> float:
    cc = LustreCluster(osts=4, mdses=1, clients=3, spare_osts=1,
                       commit_interval=256, device=device)
    for t in cc.ost_targets + cc.spare_targets:
        t.service.cpu_cost = 2e-3        # OST service is the choke
    w = LustreClient(cc, 0).mount()
    w.mkdir("/r5")
    fdata = _payload(192 << 10, seed=6)
    for i in range(8):
        f = w.creat(f"/r5/f{i}", stripe_count=3, stripe_size=16 << 10,
                    stripe_offset=0, pattern="raid5")
        w.write(f, fdata, offset=0)
        w.close(f)
    for t in cc.ost_targets:
        t.commit()
    if mode == "tbf":
        cc.lctl("rebuild_throttle", 200.0, 2.0)
    cc.fail_node("ost1")
    app = LustreClient(cc, 1).mount()
    app.set_jobid("app")
    af = app.creat("/app.bin", stripe_count=2, stripe_size=16 << 10,
                   stripe_offset=2)       # lives on the live OSTs
    maint = LustreClient(cc, 2).mount()
    chunk = _payload(4 << 10, seed=7)
    off = [0]

    def app_burst():
        # small write + fsync per op: every op is a real wire RPC
        for _ in range(6):
            app.write(af, chunk, offset=off[0])
            app.fsync(af)
            off[0] += len(chunk)

    def rebuild_step():
        # one file per round: each burst contends with a live slice of
        # rebuild traffic
        maint.rebuild_ost("OST0001", cc.spare_uuids[0], limit=1)

    # rebuild first in thunk order: the app must observe the rebuild's
    # occupancy of the OST services, not the reverse
    for _ in range(8):
        thunks = ([rebuild_step] if mode != "none" else []) + [app_burst]
        cc.sim.parallel(thunks)
    hist = merge_jobid_histograms(
        [cc.sim.metrics.target_summary(t.uuid)
         for t in cc.ost_targets + cc.spare_targets])
    return hist["app"]["p99_s"]


def raid5_metrics(device="cuda") -> dict:
    """The `raid5` section of BENCH_rpc.json, with parity on `device`."""
    out = _cold_reads_and_rebuild(device)
    base, tbf, fifo = (_p99_during_rebuild(m, device)
                       for m in ("none", "tbf", "fifo"))
    out["throttle"] = {
        "baseline_p99_s": base, "tbf_p99_s": tbf, "fifo_p99_s": fifo,
        "tbf_p99_ratio": round(tbf / max(1e-9, base), 3),
        "fifo_p99_ratio": round(fifo / max(1e-9, base), 3),
    }
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    print(json.dumps(raid5_metrics(ap.parse_args().device), indent=1))
