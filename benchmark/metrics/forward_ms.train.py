"""Device ms a step of the port's ``train.forward`` spans: the model's
forward and the loss (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_step("train.forward")
