"""Checkpoint save/restore bandwidth (the framework's flagship workload).

Sweeps parallel writer count and stripe count for a 16 MiB model state of
16 leaves on 8 OSTs; reports virtual-time bandwidth + the parity-coding
overhead (ch. 15).  The port of `benchmarks/bench_checkpoint.py`: the
leaves are torch tensors on `--device`, made from the reference's numpy
draw, and every number is a virtual-time rate of the simulator, so the
dict equals the reference's on any device.  In the parity row
(`w4_s4_p`) each leaf's parity is one call of the XOR kernel.

    PYTHONPATH=src python -m repro_torch.tools.bench_checkpoint [--device cpu]

Writes results/bench/torch_checkpoint.json.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.core import LustreCluster
from repro_torch.fsio import LustreClient
from repro_torch.kernels.ops import resolve_device
from repro_torch.tools.bench_common import save, table, vtime

# (writers, stripes, parity), the reference's rows
ROWS = [(1, 1, False), (1, 4, False), (2, 4, False), (4, 4, False),
        (4, 8, False), (4, 4, True)]


def state(n_leaves=16, leaf_kb=1024, device="cpu") -> dict:
    rng = np.random.default_rng(0)
    return {f"layer{i:02d}": torch.from_numpy(rng.standard_normal(
        leaf_kb * 256).astype(np.float32)).to(device)
        for i in range(n_leaves)}


def run(device="cuda") -> dict:
    dev = resolve_device(device)
    out = {}
    tree = state(device=dev)
    total = sum(v.numel() * v.element_size() for v in tree.values())
    rows = []
    for writers, stripes, parity in ROWS:
        c = LustreCluster(osts=8, mdses=1, clients=max(writers, 1),
                          commit_interval=512, device=dev)
        ws = [LustreClient(c, i).mount() for i in range(writers)]
        cm = CheckpointManager(ws, stripe_count=stripes,
                               stripe_size=1 << 20, parity=parity)
        _, t_save = vtime(c, lambda: cm.save(1, tree))
        _, t_rest = vtime(c, lambda: cm.restore(1))
        key = f"w{writers}_s{stripes}{'_p' if parity else ''}"
        out[key] = {"writers": writers, "stripes": stripes,
                    "parity": parity,
                    "save_MBps": round(total / t_save / 1e6, 1),
                    "restore_MBps": round(total / t_rest / 1e6, 1)}
        rows.append([writers, stripes, parity,
                     f"{out[key]['save_MBps']:.0f}",
                     f"{out[key]['restore_MBps']:.0f}"])
    table("checkpoint bandwidth (16 MiB state, 8 OSTs)",
          ["writers", "stripes", "parity", "save MB/s", "restore MB/s"],
          rows)
    save("torch_checkpoint", out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
