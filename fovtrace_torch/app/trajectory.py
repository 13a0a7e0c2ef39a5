"""Gaze + camera trajectory sources (counterpart of
`fovtrace/app/trajectory.py`, numpy only).

The reference reads gaze from the mouse cursor as an eye-tracker stand-in
(`gui.cpp:48-116` cursorPosCallback) and the camera from mouse drags.
Headless runs replace both with data:
a parametric trajectory (fixed / circle / lissajous) or a CSV file with
one `frame,gy,gx[,eye_x,eye_y,eye_z,tgt_x,tgt_y,tgt_z]` row per frame.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np


def fixed(height: int, width: int, n_frames: int,
          gy: Optional[int] = None, gx: Optional[int] = None):
    """Gaze pinned to a point (default: screen center)."""
    gy = height // 2 if gy is None else gy
    gx = width // 2 if gx is None else gx
    return [(gy, gx)] * n_frames


def circle(height: int, width: int, n_frames: int,
           radius_frac: float = 0.25, period: int = 120):
    """Gaze orbiting the screen center — the standard foveation stress
    test (every region transitions fovea -> periphery)."""
    cy, cx = height / 2.0, width / 2.0
    r = radius_frac * min(height, width)
    out = []
    for f in range(n_frames):
        a = 2.0 * math.pi * (f % period) / period
        out.append((int(cy + r * math.sin(a)), int(cx + r * math.cos(a))))
    return out


def lissajous(height: int, width: int, n_frames: int,
              ax: float = 3.0, ay: float = 2.0, period: int = 240):
    """Lissajous sweep covering the full screen (saccade-like coverage)."""
    cy, cx = height / 2.0, width / 2.0
    out = []
    for f in range(n_frames):
        t = 2.0 * math.pi * (f % period) / period
        out.append((
            int(cy + 0.4 * height * math.sin(ay * t)),
            int(cx + 0.4 * width * math.sin(ax * t + math.pi / 4)),
        ))
    return out


def from_csv(path: str, height: int, width: int, n_frames: int):
    """Load `frame,gy,gx[,eye...,target...]` rows; clamps to screen and
    repeats the last row if the file is shorter than n_frames.

    Returns (gazes, poses) where poses is None or a list of
    (eye[3], target[3]) float tuples.
    """
    gazes: List[Tuple[int, int]] = []
    poses: List[Tuple[np.ndarray, np.ndarray]] = []
    has_pose = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.lower().startswith("frame"):
                continue
            parts = [p for p in line.replace(",", " ").split() if p]
            gy = int(np.clip(int(float(parts[1])), 0, height - 1))
            gx = int(np.clip(int(float(parts[2])), 0, width - 1))
            gazes.append((gy, gx))
            if len(parts) >= 9:
                has_pose = True
                poses.append((
                    np.asarray([float(x) for x in parts[3:6]], np.float32),
                    np.asarray([float(x) for x in parts[6:9]], np.float32),
                ))
    if not gazes:
        raise ValueError(f"no gaze rows in {path}")
    while len(gazes) < n_frames:
        gazes.append(gazes[-1])
        if has_pose:
            poses.append(poses[-1])
    return gazes[:n_frames], (poses[:n_frames] if has_pose else None)


SOURCES = {"fixed": fixed, "circle": circle, "lissajous": lissajous}


def make(name: str, height: int, width: int, n_frames: int):
    if name in SOURCES:
        return SOURCES[name](height, width, n_frames), None
    return from_csv(name, height, width, n_frames)
