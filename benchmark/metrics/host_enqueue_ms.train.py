"""Host ms a step inside the port's ``train.step`` spans: the time the host
takes to enqueue a step, which sets the pace once it exceeds the device's;
a wait on the device inside the step (a synchronize, a full launch queue)
counts in it (``spans.py``)."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_step()
