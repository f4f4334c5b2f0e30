"""State bytes restored over the seconds spent in restores (the
benchmark's spans around `CheckpointManager.restore` and `retain`), in
GB/s."""


def read(run):
    units = [u for u in run.units if "restore_s" in u]
    if not units:
        return None
    return sum(u["bytes"] / 2 for u in units) / sum(
        u["restore_s"] for u in units) / 1e9
