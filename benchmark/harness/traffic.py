"""The one generator of every traffic mix. A mix is a data file,
benchmark/traffic/<name>.json, whose "kind" says what it drives:

  view   a viewer in motion, closed loop: per frame, the camera's eye and
         target and the gaze pixel (`view_sequence`)
  train  an inverse-rendering job, closed loop: the start's perturbation
         (`train_start`); the steps are indexed by their number

Everything is drawn from the run's seed and indexed by frame or step
number, never by wall time, so a faster program sees the same sequence.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

MAX_FRAMES = 1 << 16


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream); any whole seed, of
    any sign or size."""
    return np.random.default_rng([seed & ((1 << 64) - 1), seed < 0, stream])


@dataclasses.dataclass(frozen=True)
class ViewSequence:
    eyes: np.ndarray      # [F, 3] float64
    target: tuple         # the look-at point, every frame
    gazes: np.ndarray     # [F, 2] int64 (gy, gx)

    def frame(self, f: int):
        """(eye, target, (gy, gx)) of frame f."""
        return (tuple(self.eyes[f]), self.target,
                (int(self.gazes[f, 0]), int(self.gazes[f, 1])))


def view_sequence(seed: int, mix: dict, config: dict,
                  frames: int = MAX_FRAMES) -> ViewSequence:
    """The orbit: the eye yaws about the target at the configured eye's
    horizontal radius and height, `yaw_deg_per_frame` a frame, from a
    seeded start angle in a seeded direction; the gaze holds fixations of
    a seeded length, then jumps by a seeded saccade in a uniform
    direction, clamped to the screen."""
    cam = config["camera"]
    eye0 = np.asarray(cam["eye"], np.float64)
    tgt = np.asarray(cam["target"], np.float64)
    w, h = config["width"], config["height"]
    r = rng_of(seed, 0)
    start = math.radians(mix["start_yaw_deg"]
                         + r.uniform(-1.0, 1.0) * mix["start_yaw_jitter_deg"])
    sign = 1.0 if r.random() < 0.5 else -1.0
    radius = math.hypot(eye0[0] - tgt[0], eye0[2] - tgt[2])
    ang = start + sign * np.radians(mix["yaw_deg_per_frame"]) * np.arange(
        frames)
    eyes = np.stack([tgt[0] + radius * np.cos(ang),
                     np.full(frames, eye0[1]),
                     tgt[2] + radius * np.sin(ang)], axis=1)

    g = rng_of(seed, 1)
    lo, hi = mix["fixation_frames"]
    slo, shi = mix["saccade_width_frac"]
    gazes = np.empty((frames, 2), np.int64)
    gy, gx = (h - 1) / 2.0, (w - 1) / 2.0
    f = 0
    while f < frames:
        n = int(g.integers(lo, hi + 1))
        gazes[f:f + n] = (int(round(gy)), int(round(gx)))
        f += n
        amp = g.uniform(slo, shi) * w
        phi = g.uniform(0.0, 2.0 * math.pi)
        gy = min(max(gy + amp * math.sin(phi), 0.0), h - 1.0)
        gx = min(max(gx + amp * math.cos(phi), 0.0), w - 1.0)
    return ViewSequence(eyes=eyes, target=tuple(tgt), gazes=gazes)


def train_start(seed: int, mix: dict) -> np.ndarray:
    """[3] float32: the eye's start offset, `eye_perturb` long in a seeded
    direction."""
    d = rng_of(seed, 2).normal(size=3)
    d = d / np.linalg.norm(d) * mix["eye_perturb"]
    return d.astype(np.float32)


def reservoir(seed: int):
    """A seeded draw of one frame (or step) uniformly from however many
    complete: call it with each index in turn; True means keep this one
    in place of the one kept so far."""
    r = rng_of(seed, 3)
    return lambda i: bool(r.random() * (i + 1) < 1.0)
