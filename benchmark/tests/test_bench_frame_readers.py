"""The sharded cell's frame times, per layer: read from the traced run's
untraced window frames, nothing where there are none."""

import numpy as np
import pytest

from harness import spec

LAT = [210.0, 250.0, 230.0, 220.0, 400.0, 215.0, 225.0, 240.0, 235.0, 205.0]


@pytest.mark.parametrize("metric, want", [
    ("frame_ms.sharded", sum(LAT) / len(LAT)),
    ("frame_p90_ms.sharded", float(np.percentile(LAT, 90))),
])
def test_reader_reads_the_frames(metric, want):
    rec = {"clock": {"latency_ms": LAT, "enqueue_ms": []}}
    assert spec.reader(metric)(rec) == pytest.approx(want)
    assert spec.reader(metric)({"clock": {"latency_ms": []}}) is None
    assert spec.reader(metric)({"clock": {}}) is None


def test_frame_times_leave_the_sharded_cell_per_layer():
    """frame_ms and frame_p90_ms are end to end in the one-card cells and
    per layer, under their `.sharded` names, in the sharded cell, which
    keeps set-up and memory a card end to end."""
    b = spec.load()

    def names(cell, kind):
        return {m["name"] for m in spec.cell(b, cell)[kind]}

    rows4 = "city-uhd-rows4.orbit"
    assert names(rows4, "end_to_end") == {"setup_s", "memory_per_card_gb"}
    assert {"frame_ms.sharded", "frame_p90_ms.sharded"} <= names(
        rows4, "per_layer")
    for cell in ("city-uhd.orbit", "earth-uhd.orbit"):
        assert names(cell, "end_to_end") == {"frame_ms", "frame_p90_ms",
                                             "setup_s"}
