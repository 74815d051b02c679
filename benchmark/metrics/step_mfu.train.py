"""The train step's useful FLOPs a second over the card's dense bf16 peak, in
%: the steps of the window before the profiler started, at the useful
count of ``flops.step_flops_per_clip``."""

from benchmark.flops import known, peaks, step_flops_per_clip


def read(run):
    h = run.host
    if not h.get("steps") or not known(run.device_name):
        return None
    clips_per_s = h["steps"] * h["batch"] / h["window_s"]
    flops = step_flops_per_clip(run.cell.config["model"], h["n_real"])
    return 100.0 * clips_per_s * flops / peaks(run.device_name)["bf16_flops"]
