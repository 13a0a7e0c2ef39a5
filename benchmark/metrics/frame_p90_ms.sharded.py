"""frame_p90_ms of a sharded frame, per layer: the 90th percentile of
the traced run's untraced window frames' latencies, in milliseconds (as
harness/viewer.frame_stats takes it)."""

import numpy as np


def read(rec):
    xs = rec["clock"].get("latency_ms")
    return float(np.percentile(xs, 90)) if xs else None
