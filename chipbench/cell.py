"""A cell, found by name: its entry in `BENCHMARK.json`, its configuration
file, its traffic file, its limits, and the per-layer metrics that apply
to it; and one run of it (`execute`): set-up, the measured window, the
metrics, then the check of what the window produced."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import time

import torch
from torch.profiler import record_function

from chipbench import trace as trace_mod

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    home: pathlib.Path          # the benchmark's folder

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, bench: pathlib.Path | None = None) -> Cell:
    """The cell `name` of the `BENCHMARK.json` at `bench` (the checkout's,
    beside this folder, by default); its files are looked up in the
    folder beside that file that holds this package's layout."""
    bench = bench or HERE.parent / "BENCHMARK.json"
    spec = json.loads(pathlib.Path(bench).read_text())
    home = pathlib.Path(bench).resolve().parent / HERE.name
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((home.parent / conf["file"]).read_text())
    traffic = json.loads((home / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((home / "limits" / f"{name}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if _applies(m, name) and m["moves"] in names]
    return Cell(name, w["chips"], config, traffic, limits, e2e, layer, home)


def reader(cell: Cell, metric: str):
    """The `read(run)` function of `metrics/<metric>.py`, or where there
    is none, of `metrics/<metric up to its first dot>.py` (one reader
    for `device_idle.prefill`, `device_idle.train`, ...)."""
    path = cell.home / "metrics" / f"{metric}.py"
    if not path.exists():
        path = path.with_name(metric.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        f"chipbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a reader sees: the cell, the units of the window (each a dict
    with t0, t1 and the kind's counts), the window's seconds, and with a
    trace its summary (`trace.summarize`)."""
    cell: Cell
    units: list
    window_s: float
    setup_s: float
    trace: dict | None = None


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, job=None) -> dict:
    """One run of `cell`.  Returns the result line's object, its `checks`
    last.  `job` replaces the kind's job (tests break the timed path
    through it)."""
    if job is None:
        kinds = importlib.import_module(f"chipbench.kinds.{cell.kind}")
        job = kinds.Job(cell, seed, device)
    job.setup()
    _sync(device)
    prof = trace_mod.start(device) if trace else None
    units, failed = [], 0
    t0 = time.perf_counter()
    t0_ns = time.time_ns()
    deadline = t0 + seconds
    while not units or time.perf_counter() < deadline:
        i = len(units)
        with record_function(f"unit:{job.unit_name}"):
            u0 = time.perf_counter()
            try:
                u = job.unit(i)
            except Exception as exc:            # counted, never hidden
                _sync(device)
                u = {"error": repr(exc)}
                failed += 1
            u["t0"], u["t1"] = u0, time.perf_counter()
        units.append(u)
    t1 = units[-1]["t1"]
    t1_ns = t0_ns + int((t1 - t0) * 1e9)
    window_s = t1 - t0
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = trace_mod.summarize(prof, t0_ns, t1_ns)
        del prof
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(0)
           if cuda else 0}
    run = Run(cell, units, window_s, t0 - t_start, summary)
    good = [u for u in units if "error" not in u]
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(cell, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    else:
        values = job.end_to_end(good, window_s)
        values["setup_s"] = run.setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    job.release()
    numbers = job.check(good)
    checks = {k: {"value": numbers.get(k, math.inf), "limit": limit}
              for k, limit in cell.limits.items()}
    correct = (failed == 0 and bool(good) and all(
        c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": correct, "attempted": len(units), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = trace_mod.breakdown(summary)
    if failed:
        out["errors"] = sorted({u["error"] for u in units if "error" in u})
    out["checks"] = checks
    return out
