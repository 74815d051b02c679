"""Device ms a step of the port's ``train.backward`` spans: the backward,
its remat re-forward included (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_step("train.backward")
