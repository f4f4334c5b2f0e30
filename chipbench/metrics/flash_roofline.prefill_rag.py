"""The attention kernel's (K3, `flash_fwd_*`) share of its roofline over
the traced prefill window of a model type that `archs/<model_type>.py`
maps: the sum of each launch's bound (chipbench/count.flash_bound_s at
the prompt's length, H, Hkv and D of the configuration) over the
kernel's device time, in percent.  Nothing unless every request launched
K3 once an attention layer and the trace holds as many launches."""
import importlib

from chipbench import count


def read(run):
    if run.trace is None:
        return None
    cfg = run.cell.config
    arch = importlib.import_module(f"chipbench.archs.{cfg['model_type']}")
    per = arch.layers_of(cfg, "attention")
    units = [u for u in run.units if "tokens" in u]
    if not units or any(u.get("flash_launches") != per for u in units):
        return None
    times = [(e - s) / 1e9 for s, e, name in run.trace["device"]
             if "flash_fwd" in name]
    if len(times) != per * len(units):
        return None
    H, Hkv, D = arch.attention_shape(cfg)
    bound = sum(per * count.flash_bound_s(1, H, Hkv, u["tokens"], D)
                for u in units)
    return 100.0 * bound / sum(times)
