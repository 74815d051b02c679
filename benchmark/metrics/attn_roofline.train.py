"""K2f and K2b's share of their roofline, in %: the least time of a step's
attention (``flops.attention_work`` at n_real) over the traced steps'
device time of the kernels that ``layers/`` names K2f and K2b."""

from benchmark.flops import attention_work, least_seconds


def read(run):
    t = run.kernel_seconds("K2f", "K2b")
    if not t:
        return None
    h = run.host
    work = attention_work(run.cell.config["model"], h["batch"], h["n_real"])
    return 100.0 * least_seconds(*work, run.device_name) * run.trace.steps / t
