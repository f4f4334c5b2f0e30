"""Model FLOP utilisation of the prefill window: the matrix-product
operations of every prompt token prefilled (chipbench/count: experts at
top-k, a shared block once per application, no attention scores, no
embedding, the head at each prompt's last position only) over the bf16
peak times the traced window, in percent."""
from chipbench import count


def read(run):
    if run.trace is None:
        return None
    cfg = run.cell.config
    flops = sum(count.prefill_flops(cfg, u["tokens"]) for u in run.units
                if "tokens" in u)
    return 100.0 * flops / (count.PEAK_FLOPS[cfg["run"]["compute_dtype"]]
                            * run.trace["window_s"])
