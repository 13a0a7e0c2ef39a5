"""The traffic generator repeats by seed and indexes by frame."""

import json

import numpy as np

from harness import spec, traffic

CFG = json.loads((spec.BENCH / "configs" / "city-uhd.json").read_text())
ORBIT = json.loads((spec.BENCH / "traffic" / "orbit.json").read_text())
TRAIN = json.loads((spec.BENCH / "traffic" / "train.json").read_text())
BIG = 2 ** 31 + 12345


def test_view_sequence_repeats_by_seed():
    a = traffic.view_sequence(BIG, ORBIT, CFG, frames=500)
    b = traffic.view_sequence(BIG, ORBIT, CFG, frames=500)
    assert np.array_equal(a.eyes, b.eyes)
    assert np.array_equal(a.gazes, b.gazes)
    c = traffic.view_sequence(BIG + 1, ORBIT, CFG, frames=500)
    assert not np.array_equal(a.eyes, c.eyes)


def test_view_sequence_is_indexed_by_frame():
    short = traffic.view_sequence(-7, ORBIT, CFG, frames=200)
    long = traffic.view_sequence(-7, ORBIT, CFG, frames=2000)
    for f in (0, 1, 57, 199):
        assert short.frame(f) == long.frame(f)


def test_orbit_and_saccades_follow_the_mix():
    s = traffic.view_sequence(3, ORBIT, CFG, frames=3000)
    tgt = np.asarray(s.target)
    rad = np.hypot(s.eyes[:, 0] - tgt[0], s.eyes[:, 2] - tgt[2])
    assert np.allclose(rad, 5.0) and np.allclose(s.eyes[:, 1], 2.5)
    ang = np.unwrap(np.arctan2(s.eyes[:, 2] - tgt[2], s.eyes[:, 0] - tgt[0]))
    assert np.allclose(np.abs(np.diff(np.degrees(ang))), 0.5)
    moves = np.flatnonzero(np.any(np.diff(s.gazes, axis=0) != 0, axis=1))
    runs = np.diff(moves)
    assert runs.min() >= 18 and runs.max() <= 36
    assert (s.gazes[:, 0] >= 0).all() and (s.gazes[:, 0] < CFG["height"]).all()
    assert (s.gazes[:, 1] >= 0).all() and (s.gazes[:, 1] < CFG["width"]).all()


def test_train_start_and_reservoir_repeat_by_seed():
    assert np.array_equal(traffic.train_start(BIG, TRAIN),
                          traffic.train_start(BIG, TRAIN))
    d = traffic.train_start(5, TRAIN)
    assert abs(np.linalg.norm(d) - 0.3) < 1e-6
    picks = []
    for _ in range(2):
        keep = traffic.reservoir(BIG)
        picks.append([i for i in range(300) if keep(i)])
    assert picks[0] == picks[1] and picks[0][0] == 0
