"""The SSD kernel's (`ssd_prep`, `ssd_states`, `ssd_scan`, `ssd_output`)
share of its roofline over the traced prefill window: the sum over the
Mamba2 blocks of each block's bound (`archs/<model_type>.ssd_bound_s` at
the prompt's length: the largest of its bytes at 3.35 TB/s, its products
at the bf16 peak and its exponentials at 16 a clock an SM) over the sum
of the four kernels' device time, in percent.  Nothing unless every
request launched the kernel once a Mamba2 layer and the trace holds each
of its four kernels once a launch."""
import importlib
import re

KERNELS = re.compile(r"\bssd_(prep|states|scan|output)\b")


def read(run):
    if run.trace is None:
        return None
    cfg = run.cell.config
    arch = importlib.import_module(f"chipbench.archs.{cfg['model_type']}")
    per = arch.layers_of(cfg, "mamba")
    units = [u for u in run.units if "tokens" in u]
    if not units or any(u.get("ssd_launches") != per for u in units):
        return None
    times = [(e - s) / 1e9 for s, e, name in run.trace["device"]
             if KERNELS.search(name)]
    if len(times) != 4 * per * len(units):
        return None
    bound = sum(per * arch.ssd_bound_s(cfg, u["tokens"]) for u in units)
    return 100.0 * bound / sum(times)
