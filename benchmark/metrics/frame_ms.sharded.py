"""frame_ms of a sharded frame, per layer: the mean latency of the traced
run's untraced window frames (each ending in a sync), in milliseconds.
Its ranks wait on each other at every collective, so the frame follows
the slowest host of four, and it swings by more from run to run than an
end-to-end bound may allow."""

import statistics


def read(rec):
    xs = rec["clock"].get("latency_ms")
    return statistics.fmean(xs) if xs else None
