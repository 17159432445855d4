"""Peak device memory allocated in the window (``max_memory_allocated``),
GiB. Recorded; it decides nothing."""

from benchmark.readers import peak_gib


def read(ctx):
    return peak_gib(ctx)
