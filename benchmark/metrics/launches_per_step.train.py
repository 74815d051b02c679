"""The traced steps' kernel-launch calls of the CUDA APIs
(``cudaLaunchKernel*``, ``cuLaunchKernel*``) inside the port's
``train.step`` spans, put on the trace's clock by ``spans.py``, a step."""

from benchmark import spans


def read(run):
    return spans.launches_per_step(run)
