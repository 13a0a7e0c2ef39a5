"""Host milliseconds inside the program's call per frame (step), before
the sync that ends it: the median over the traced run's untraced window
frames (steps). It holds the host's own waits inside the call (the
camera inverse's round trips)."""

import statistics


def read(rec):
    xs = rec["clock"]["enqueue_ms"]
    return statistics.median(xs) if xs else None
