"""The readers of the program's spans (metrics/*.py with source
program_span) on a hand-made traced window: two frames, times in
microseconds; and None where the program opened no such span."""

import pytest

from harness import spec

FRAMES = 2


def _range(name, ts, dur, tid=1):
    return {"name": name, "ts": float(ts), "dur": float(dur), "tid": tid}


def _kernel(ts, dur, launch_ts, tid=1, name="k"):
    return {"name": name, "ts": float(ts), "dur": float(dur),
            "launch_ts": float(launch_ts), "launch_tid": tid}


def _rec(spans=True):
    ranges = []
    if spans:
        for f in range(FRAMES):
            o = 1000.0 * f
            ranges += [_range("fov.frame", o, 900),
                       _range("GB", o + 10, 90),
                       _range("fov.gbuffer", o + 10, 90),
                       _range("fov.sync.view_matrix", o + 20, 5),
                       _range("fov.sampling", o + 100, 200),
                       _range("fov.sync.dither_table", o + 150, 10),
                       _range("fov.sync.dither_table", o + 170, 10),
                       _range("fov.shade", o + 300, 100),
                       _range("fov.shade.bounce0", o + 300, 50),
                       _range("fov.coll.all_reduce_sum", o + 410, 5),
                       _range("fov.reconstruct", o + 420, 80)]
        ranges.append(_range("fov.coll.all_gather_rows", 950, 20))
    kernels = [
        _kernel(40, 30, 15),        # launched in fov.gbuffer
        _kernel(120, 30, 110),      # fov.sampling
        _kernel(320, 40, 305),      # fov.shade (bounce 0)
        _kernel(1330, 20, 1301),    # fov.shade
        _kernel(430, 60, 425),      # fov.reconstruct
        _kernel(1430, 10, 1425),    # fov.reconstruct
        _kernel(700, 10, 425, tid=2),   # another thread: in no span
    ]
    devops = [{"name": "Memcpy HtoD", "ts": 250.0, "dur": 100.0}]
    return {"units": FRAMES, "window": (0.0, 2000.0), "window_us": 2000.0,
            "ranges": ranges, "kernels": kernels, "devops": devops,
            "backward": [], "host": []}


# fov.sampling [100, 300]: busy 120-150 and 250-300 -> 120 us idle;
# [1100, 1300]: none busy -> 200 us; over two frames
WANT = {
    "sampling_idle_ms.view": (120 + 200) * 1e-3 / FRAMES,
    "host_syncs_per_frame.view": 3.0,
    "gbuffer_span_device_ms.view": 30 * 1e-3 / FRAMES,
    "shade_span_device_ms.view": (40 + 20) * 1e-3 / FRAMES,
    "reconstruct_span_device_ms.view": (60 + 10) * 1e-3 / FRAMES,
    "collectives_per_frame.view": 1.5,
}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_the_spans(metric):
    assert spec.reader(metric)(_rec()) == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_finds_nothing_without_the_spans(metric):
    assert spec.reader(metric)(_rec(spans=False)) is None


def test_counts_read_zero_in_a_frame_with_spans_but_none_of_theirs():
    rec = _rec()
    rec["ranges"] = [r for r in rec["ranges"]
                     if not r["name"].startswith(("fov.sync.", "fov.coll."))]
    for metric in ("host_syncs_per_frame.view", "collectives_per_frame.view"):
        assert spec.reader(metric)(rec) == 0.0


def test_every_span_reader_is_declared():
    declared = {m["name"]: m for m in spec.load()["per_layer"]}
    for metric in WANT:
        assert declared[metric]["source"] == "program_span"
        # the sharded cell's spans move its one end-to-end metric but
        # set-up (PERF.md section 2)
        assert declared[metric]["moves"] == (
            "memory_per_card_gb" if metric == "collectives_per_frame.view"
            else "frame_ms")
