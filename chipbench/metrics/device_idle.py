"""The share of the traced window in which no operation ran on the device
(one minus the union of its operations' intervals), in percent: the
reader of every `device_idle.<layer>` metric."""


def read(run):
    if run.trace is None:
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
