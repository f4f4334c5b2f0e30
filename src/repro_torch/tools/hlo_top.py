"""Top-K cost breakdown of a recorded step: `repro.tools.hlo_top` for the
port, the dry-run's "profiler".

Reads the ops a `hlo_cost.CostCounter(keep_ops=True)` recorded and
reports the heaviest: collectives by bytes, products by FLOPs and ops by
traffic, each summed over the calls of one op at one output shape and
multiplied by its loop trip count where a loop was cut.
"""
from __future__ import annotations

from collections import defaultdict

from repro_torch.tools.hlo_cost import CostCounter


def top_costs(ops: list, k: int = 12) -> dict:
    """{"collectives", "dots", "traffic"}: lists of (value, calls, op,
    multiplier, output shape), largest first."""
    sums: dict = defaultdict(lambda: [0.0, 0])
    for what, value, op, m, shape in ops:
        s = sums[(what, op, m, shape)]
        s[0] += value
        s[1] += 1
    out = {"collective": [], "flops": [], "traffic": []}
    for (what, op, m, shape), (value, calls) in sums.items():
        out[what].append((value, calls, op, m, shape))
    for rows in out.values():
        rows.sort(key=lambda r: -r[0])
    return {"collectives": out["collective"][:k], "dots": out["flops"][:k],
            "traffic": out["traffic"][:k]}


def record(fn, *args, cut_loops: bool = False, **kwargs) -> list:
    """The ops fn(*args, **kwargs) ran, as `top_costs` reads them."""
    with CostCounter(cut_loops=cut_loops, keep_ops=True) as c:
        fn(*args, **kwargs)
    return c.ops


def print_top(ops: list, k: int = 10) -> dict:
    out = top_costs(ops, k)
    for section, unit in (("collectives", "B"), ("dots", "F"),
                          ("traffic", "B")):
        print(f"--- top {section} ---")
        for value, calls, op, m, shape in out[section]:
            print(f"  {value:.3e}{unit}  x{calls:<6} trips {m:<6} "
                  f"{op:<40} {shape}")
    return out
