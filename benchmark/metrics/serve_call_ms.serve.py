"""The mean host-clock time of the serve call that the batcher makes (H2D,
eval pipeline, forward, softmax, D2H), over the calls that started before
the profiler did."""


def read(run):
    return run.host.get("serve_call_ms")
