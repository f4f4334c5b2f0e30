"""Multi-pod dry-run: `repro.launch.dryrun` for the port.

Every (arch x shape) cell's step is built on the production mesh over a
fake process group of 256 (or 512) ranks and run once under
FakeTensorMode: parameters, optimizer state, batch and caches are
DTensors whose local shards are fake, so nothing is allocated and no
card is needed.  `hlo_cost.CostCounter` records the rank's local ops and
the collectives DTensor runs; the roofline terms come from those, with
the H100's denominators.  `memory` is per device: `argument_bytes` the
local parameters, state, batch and cache, `temp_bytes` the peak of the
storages the step creates above them.  `lower_s` is the time to build the
step and place its arguments, `compile_s` the time of the traced run
(there is no compiler).  Loops the models declare (`layers.loop`: RWKV-6's
time loop, Zamba2's chunk loop) run one trip whose counts are multiplied.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_config
from repro_torch.launch import cells as cells_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.config import SHAPES
from repro_torch.optim import adamw
from repro_torch.tools import hlo_cost, roofline
from repro_torch.train import steps as steps_mod


def fake_group(world: int):
    """The default process group as a fake one of `world` ranks (this
    process is rank 0; collectives do nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world \
                and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tensors) -> int:
    """One device's bytes of `tensors` (a DTensor's local shard)."""
    total = 0
    for t in tensors:
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += hlo_cost.shape_bytes(loc.shape, loc.dtype)
    return total


def _leaves(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _args(cfg, rc, mesh):
    """The step's arguments, fake, on `mesh` (or whole on one device):
    (args tuple, their local bytes)."""
    pdt = getattr(torch, rc.param_dtype)
    params = L.tree_map(lambda d: torch.empty(d.shape, dtype=pdt),
                        registry.param_defs(cfg))
    if mesh is not None:
        params = L.tree_distribute(params, mesh,
                                   steps_mod.param_specs(cfg, rc, mesh))
    gen = torch.Generator("cpu").manual_seed(0)
    if rc.kind == "train":
        batch = steps_mod.make_batch(cfg, rc, gen, with_labels=True)
        args = (params, adamw.init_state(params), batch)
    elif rc.kind == "prefill":
        args = (params, steps_mod.make_batch(cfg, rc, gen, with_labels=False))
    else:
        cache = steps_mod.decode_cache(cfg, rc, device="cpu", mesh=mesh)
        token = torch.zeros((rc.global_batch, 1), dtype=torch.int32)
        args = (params, cache, token, rc.seq_len - 1)
    return args, _local_bytes(_leaves(args))


def trace_cell(cfg, rc, mesh=None) -> dict:
    """One step of (cfg, rc) traced under FakeTensorMode on `mesh` (a
    DeviceMesh over a fake process group), or on one device without: the
    timing, memory, cost and roofline entries of a cell's record."""
    n_chips = mesh.size() if mesh is not None else 1
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step = steps_mod.build_step(cfg, rc, device="cpu", mesh=mesh)
        args, arg_bytes = _args(cfg, rc, mesh)
        t_lower = time.time() - t0
        with hlo_cost.CostCounter(cut_loops=True) as counter:
            out = step(*args)
        t_run = time.time() - t0 - t_lower
        ins = {id(t) for t in _leaves(args)}
        out_bytes = _local_bytes([t for t in _leaves(out)
                                  if id(t) not in ins])
    report = counter.report
    return {
        "lower_s": round(t_lower, 1), "compile_s": round(t_run, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": counter.peak_bytes,
            "generated_code_bytes": None,
        },
        # no compiler: its own cost analysis does not exist
        "xla_cost_analysis": {"flops": None, "bytes accessed": None},
        "hlo_cost": report.as_dict(),
        "roofline": roofline.compute(report, cfg, rc, n_chips).as_dict(),
    }


def run_cell(arch: str, shape: str, multi_pod: bool, rc_overrides=None,
             verbose: bool = True) -> dict:
    cfg = get_config(arch)
    rc = SHAPES[shape]
    base_over = cells_mod.OVERRIDES.get((arch, shape))
    if base_over:
        rc = dataclasses.replace(rc, **base_over)
    if rc_overrides:
        rc = dataclasses.replace(rc, **rc_overrides)
    n_chips = 512 if multi_pod else 256
    fake_group(n_chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    res = {"arch": arch, "shape": shape, "kind": rc.kind,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "n_chips": n_chips, **trace_cell(cfg, rc, mesh)}
    if verbose:
        _print_cell(res)
    return res


def _print_cell(out):
    r = out["roofline"]
    h = out["hlo_cost"]
    mem = out["memory"]
    print(f"== {out['arch']} x {out['shape']} on {out['mesh']} "
          f"({out['n_chips']} devices) ==")
    print(f"   build {out['lower_s']}s  traced run {out['compile_s']}s")
    print(f"   memory per device: arguments {mem['argument_bytes']:.3e}B  "
          f"temp {mem['temp_bytes']:.3e}B  outputs {mem['output_bytes']:.3e}B")
    print(f"   per-device: flops {h['flops']:.3e}  traffic "
          f"{h['traffic_bytes']:.3e}B  collective "
          f"{h['collective_bytes']:.3e}B  "
          f"({h['n_while']} loops cut: {h['trip_counts']})")
    print("   collectives: "
          + ", ".join(f"{k}={v:.2e}B" for k, v in h["collectives"].items()))
    print(f"   roofline: compute {r['compute_s']*1e3:.2f}ms  "
          f"memory {r['memory_s']*1e3:.2f}ms  "
          f"collective {r['collective_s']*1e3:.2f}ms  "
          f"-> {r['dominant']}-bound;  "
          f"useful_flops_ratio {r['useful_ratio']:.3f}  "
          f"MFU-bound {r['mfu_bound']:.3f}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--set", action="append", default=[],
                    help="RunConfig override k=v (hillclimbing)")
    args = ap.parse_args()

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    os.makedirs(args.out, exist_ok=True)
    todo = (list(cells_mod.cells()) if args.all
            else [(args.arch, args.shape)])
    failures = []
    for arch, shape in todo:
        tag = "2pod" if args.multi_pod else "1pod"
        suffix = ("_" + "_".join(f"{k}-{v}" for k, v in overrides.items())
                  if overrides else "")
        path = os.path.join(args.out, f"{arch}_{shape}_{tag}{suffix}.json")
        try:
            res = run_cell(arch, shape, args.multi_pod, overrides or None)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
        except Exception as e:       # report the cell, go on to the next
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"dry-run OK ({len(todo)} cells, "
          f"{'multi-pod 2x16x16' if args.multi_pod else 'single-pod 16x16'})")


if __name__ == "__main__":
    main()
