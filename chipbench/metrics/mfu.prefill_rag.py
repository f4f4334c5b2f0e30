"""Model FLOP utilisation of the prefill window of a model type that
`archs/<model_type>.py` counts: the matrix-product operations of every
prompt token prefilled (experts at top-k, a shared expert at every
token, the router, no attention scores, SSD or embedding, the head at
each prompt's last position only) over the bf16 peak times the traced
window, in percent."""
import importlib

from chipbench import count


def read(run):
    if run.trace is None:
        return None
    cfg = run.cell.config
    arch = importlib.import_module(f"chipbench.archs.{cfg['model_type']}")
    flops = sum(arch.prefill_flops(cfg, u["tokens"]) for u in run.units
                if "tokens" in u)
    return 100.0 * flops / (count.PEAK_FLOPS[cfg["run"]["compute_dtype"]]
                            * run.trace["window_s"])
