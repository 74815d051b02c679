"""The device's idle share of the window's train steps, in %: 1 - the
device's busy time a traced step (the union of its operations' intervals)
over the untraced window's wall time a step. The traced steps' own wall
time is not used: the profiler's cost on the host slows a host-bound step
(AST-MoE's by 5-17% on a loaded host), which would read as idle device
time. Where the card is busy throughout, the profiler's own device cost
(0.3-0.5% of a step) makes it read a little under 0."""


def read(run):
    t, h = run.trace, run.host
    if t is None or not t.device or not t.steps or not h["steps"]:
        return None
    return 100.0 * (1.0 - (t.busy_s() / t.steps) / (h["window_s"] / h["steps"]))
