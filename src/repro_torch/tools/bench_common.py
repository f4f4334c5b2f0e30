"""Shared benchmark utilities of the port: virtual-time measurement and
result I/O (the port's copy of `benchmarks/common.py`).  Results go to
`results/bench/` at the root of the checkout."""
from __future__ import annotations

import json
import pathlib

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / "bench"


def save(name: str, payload: dict) -> pathlib.Path:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / f"{name}.json"
    path.write_text(json.dumps(payload, indent=1))
    return path


def vtime(cluster, fn):
    """Run fn, return (result, virtual seconds elapsed)."""
    t0 = cluster.now
    out = fn()
    return out, cluster.now - t0


def table(title: str, headers: list[str], rows: list[list]):
    print(f"\n== {title} ==")
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              for i, h in enumerate(headers)]
    print("  " + "  ".join(str(h).ljust(w) for h, w in zip(headers, widths)))
    for r in rows:
        print("  " + "  ".join(str(v).ljust(w) for v, w in zip(r, widths)))
