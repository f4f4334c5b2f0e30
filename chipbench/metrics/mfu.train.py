"""Model FLOP utilisation of the training window: 6 x the matrix-product
parameters applied to a token (chipbench/count: experts at top-k, no
attention scores, no embedding, remat's recomputation not counted) x the
tokens of the steps, over the bf16 peak times the traced window, in
percent."""
from chipbench import count


def read(run):
    if run.trace is None:
        return None
    cfg = run.cell.config
    flops = sum(count.train_flops(cfg, u["tokens"]) for u in run.units
                if "tokens" in u)
    if not flops:
        return None
    return 100.0 * flops / (count.PEAK_FLOPS[cfg["run"]["compute_dtype"]]
                            * run.trace["window_s"])
