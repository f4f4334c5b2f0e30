"""The whole checkpoint cycle's share of the card's peak: the least time
its device work needs (each XOR launch's bound, as xor_roofline.ckpt
counts it) over the traced window, in percent.  It bounds what a faster
XOR kernel can give the cycle."""
from chipbench import count


def read(run):
    if run.trace is None:
        return None
    calls = [c for u in run.units for c in u.get("xor", ())]
    if not calls:
        return None
    return 100.0 * sum(count.xor_bound_s(K, n) for K, n in calls) / \
        run.trace["window_s"]
