"""Device ms a step of the port's ``train.optimizer`` spans: the zero-filled
gradients, the global-norm clip, the LR, Adam and ``zero_grad``
(``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_step("train.optimizer")
