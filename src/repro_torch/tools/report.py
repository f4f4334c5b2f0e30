"""Render the dry-run and roofline markdown tables from results/dryrun:
`repro.tools.report` for the port, "fits" against the H100's 80 GB."""
from __future__ import annotations

import glob
import json
import os

from repro_torch.launch.mesh import HBM_BYTES


def load(results_dir="results/dryrun"):
    out = {}
    for f in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        base = os.path.basename(f)
        # skip runs with override suffixes (arch_shape_Npod.json is the
        # canonical record)
        if not (base.endswith("_1pod.json") or base.endswith("_2pod.json")):
            continue
        with open(f) as fh:
            d = json.load(fh)
        out[(d["arch"], d["shape"], d["mesh"])] = d
    return out


def _gb(d) -> float:
    mem = d["memory"]
    return (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9


def roofline_table(cells: dict, mesh: str = "16x16") -> str:
    rows = []
    for (arch, shape, m), d in sorted(cells.items(),
                                      key=lambda kv: (kv[0][1], kv[0][0])):
        if m != mesh:
            continue
        r = d["roofline"]
        peak = _gb(d)
        dom = {"compute": "comp", "memory": "mem", "collective": "coll"}[
            r["dominant"]]
        rows.append(
            f"| {arch} | {shape} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | {dom} | "
            f"{r['useful_ratio']:.3f} | {r['mfu_bound']:.3f} | "
            f"{peak:.1f} | {'yes' if peak <= HBM_BYTES / 1e9 else 'NO'} | "
            f"{d['lower_s'] + d['compile_s']:.1f} |")
    head = ("| arch | shape | compute s | memory s | collective s | bound "
            "| useful | MFU<= | GB/dev | fits | trace s |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|")
    return head + "\n" + "\n".join(rows)


def dryrun_summary(cells: dict) -> str:
    lines = []
    for mesh in ("16x16", "2x16x16"):
        sub = [d for (a, s, m), d in cells.items() if m == mesh]
        if not sub:
            continue
        n_fit = sum(1 for d in sub if _gb(d) * 1e9 <= HBM_BYTES)
        t = sum(d["lower_s"] + d["compile_s"] for d in sub)
        lines.append(f"* **{mesh}** ({sub[0]['n_chips']} devices): "
                     f"{len(sub)}/{len(sub)} cells traced OK, "
                     f"{n_fit}/{len(sub)} fit {HBM_BYTES / 1e9:.0f} "
                     f"GB/device, total trace {t:.0f}s")
    return "\n".join(lines)


def collective_mix(cells: dict, arch: str, shape: str,
                   mesh: str = "2x16x16") -> str:
    d = cells.get((arch, shape, mesh))
    if not d:
        return ""
    colls = d["hlo_cost"]["collectives"]
    return ", ".join(f"{k}={v:.2e}B" for k, v in sorted(
        colls.items(), key=lambda kv: -kv[1]))


if __name__ == "__main__":
    import sys
    cells = load(*sys.argv[1:2])
    print(dryrun_summary(cells))
    print()
    print(roofline_table(cells))
