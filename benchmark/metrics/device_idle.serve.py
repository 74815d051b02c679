"""The device's idle share of the profiled end of the serving window, in %:
1 - the union of the device operations' intervals over the host-clock
window."""


def read(run):
    return run.idle_percent()
