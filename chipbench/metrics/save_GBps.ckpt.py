"""State bytes saved over the seconds spent in saves (the benchmark's
spans around `CheckpointManager.save`, the lost disk's bookkeeping
included), in GB/s."""


def read(run):
    units = [u for u in run.units if "save_s" in u]
    if not units:
        return None
    return sum(u["bytes"] / 2 for u in units) / sum(
        u["save_s"] for u in units) / 1e9
