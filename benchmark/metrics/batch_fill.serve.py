"""Requests answered over the batcher's device calls times its batch, in %,
over the window before the profiler started (``MicroBatcher.batches``)."""


def read(run):
    fill = run.host.get("batch_fill")
    return None if fill is None else 100.0 * fill
