"""The XOR kernel's (K1/K2, `xor_rows*`) share of its roofline over the
traced window: the sum of each launch's bound (K rows read and one
written at the memory's rate, chipbench/count.xor_bound_s, K and the
lanes worked out from each leaf's size and stripe layout) over the sum of
the kernel's device time, in percent.  Nothing when the trace's launches
are not the parity and rebuild calls the units made."""
from chipbench import count


def read(run):
    if run.trace is None:
        return None
    times = [(e - s) / 1e9 for s, e, name in run.trace["device"]
             if "xor_rows" in name]
    calls = [c for u in run.units for c in u.get("xor", ())]
    if not times or len(times) != len(calls):
        return None
    return 100.0 * sum(count.xor_bound_s(K, n) for K, n in calls) / sum(
        times)
