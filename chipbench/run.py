"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m chipbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  One process: set-up (the port's kernels
built or loaded from `build/repro_torch/`, the weights or state made on
the card from the seed, every shape of the traffic warmed up), the
measured window, the result's metrics, then the check of what the window
produced against the plain reference.  The last line of standard output
is one JSON object (`correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` `breakdown`, and last `checks`: each number
compared beside its limit, which are also the last lines of standard
error).  Without a card, or with fewer cards than the cell asks for, or
with JAX or the JAX package loaded once the window has closed, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (`sys.modules` by default) whose top-level name,
    whole, is JAX's or the JAX package's (`repro_torch` is not
    `repro`)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT / "src"))
    from chipbench.cell import execute, load_cell
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"chipbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"chipbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
