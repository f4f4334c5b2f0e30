"""The attention kernel's (K3, `flash_fwd_*`) share of its roofline over
the traced prefill window: the sum of each launch's bound
(chipbench/count.flash_bound_s at the prompt's length) over the sum of
the kernel's device time, in percent.  Nothing when the trace's launches
are not one per attention layer of each request."""
from chipbench import count


def read(run):
    if run.trace is None:
        return None
    cfg = run.cell.config
    times = [(e - s) / 1e9 for s, e, name in run.trace["device"]
             if "flash_fwd" in name]
    per = count.attention_layers(cfg)
    reqs = [u["tokens"] for u in run.units if "tokens" in u]
    if not times or len(times) != per * len(reqs):
        return None
    H, Hkv, D = count.attention_shape(cfg)
    bound = sum(per * count.flash_bound_s(1, H, Hkv, L, D) for L in reqs)
    return 100.0 * bound / sum(times)
