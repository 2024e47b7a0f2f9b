"""device.idle_pct (%): the share of the traced window in which no
kernel and no copy ran on the device (one minus the union of their
intervals over the window)."""


def read(run):
    if run.trace is None:
        return None
    start, end = run.trace.window()
    return (1.0 - run.trace.busy_s(start, end) / (end - start)) * 100
