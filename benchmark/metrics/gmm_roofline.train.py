"""K4a and K4b's share of their roofline, in %: the least time of a step's
grouped expert products (``flops.grouped_matmul_work`` at the real (token,
choice) rows, no remat re-forward) over the traced steps' device time of
the kernels that ``layers/`` names K4a and K4b."""

from benchmark.flops import grouped_matmul_work, least_seconds


def read(run):
    t = run.kernel_seconds("K4a", "K4b")
    if not t or not run.cell.config["model"].get("moe"):
        return None
    h = run.host
    work = grouped_matmul_work(run.cell.config["model"], h["batch"], h["n_real"])
    return 100.0 * least_seconds(*work, run.device_name) * run.trace.steps / t
