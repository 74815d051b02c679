"""Device ms a step of the port's ``train.pipeline`` spans: K1's log-mel,
SpecAugment, Mixup and the normalisation (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_step("train.pipeline")
