"""The yardstick's arithmetic: the ray budget's sizing rule, the published
peaks, and the least time of the intersection and adjoint kernels' work.
Frozen copies of the port's rules as of the benchmark's first version
(fovtrace_torch/bench.py `budget_frac`; chip_smoke.py's bounds), counted
from the benchmark's own inputs."""

from __future__ import annotations

import numpy as np

# H100 SXM (NVIDIA's data sheet): float32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# operations per (ray, triangle) pair: four 10-term dot products (40
# FMAs = 80) and the epilogue's 13 (ud, vd, det*det, ud + vd, |det|,
# 1/det, t_num * inv_det and 6 compares)
OPS_PER_PAIR = 93
# bytes a ray reads (origin, direction, t_min, t_max) and writes (t and
# triangle id; an rgb attenuation), and a triangle's coefficient record
RAY_IN, CLOSEST_OUT, OCCLUSION_OUT = 32, 8, 12
TRIANGLE_RECORD = 160


def budget_frac(ray_count: int, rays_dropped: int, n_pixels: int,
                frac: float = 0.50) -> float:
    """bench.py's budget sizing after its probe frame: `frac` unless the
    mask is denser than it (or dropped rays), else the mask's share plus
    2% rounded up to a twentieth, at most 1 (the ceiling in float32)."""
    need = ray_count / n_pixels
    if rays_dropped > 0 or need > frac:
        return min(1.0, float(np.ceil(np.float32((need + 0.02) * 20))) / 20)
    return frac


def isect_call_s(work: dict) -> float:
    """The least time of one intersection call (reference.cluster
    .call_work): its pairs' operations at the float32 peak or its bytes
    (each ray read and written once, every triangle some ray needs read
    once) at the HBM rate, whichever is longer. The pairs are those of
    triangle-by-triangle box culling, front to back, stopping at a
    closest hit or at the first opaque blocker: fewer than any walk over
    boxes of several triangles tests."""
    out = CLOSEST_OUT if work["kind"] == "closest_hit" else OCCLUSION_OUT
    nbytes = (work["rays"] * (RAY_IN + out)
              + work["triangles"] * TRIANGLE_RECORD)
    return max(work["pairs"] * OPS_PER_PAIR / PEAK_F32,
               nbytes / PEAK_BYTES)


def material_adjoint_s(n: int, m: int, k: int) -> float:
    """n ids and the [k, n] cotangent read, the [m, k] table written."""
    return (4 * n + 4 * k * n + 4 * m * k) / PEAK_BYTES


def envmap_adjoint_s(n: int, h: int, w: int) -> float:
    """fx, fy and the [3, n] cotangent read, the [h, w, 3] map written."""
    return (20 * n + 12 * h * w) / PEAK_BYTES


def bounce_fronts(n: int, max_depth: int, fracs) -> list:
    """The width of each bounce's front in a dense shade of n rays: n,
    then each bounce's static budget (shade_v's rule)."""
    widths, width = [n], n
    for bounce in range(max_depth - 1):
        budget = int(n * fracs[min(bounce, len(fracs) - 1)])
        budget = min(max(1024, (budget + 1023) // 1024 * 1024), width)
        widths.append(budget)
        width = budget
    return widths


def train_adjoints_s(config: dict, render: dict) -> float:
    """The least time of one dense train step's adjoints: per bounce,
    the material table's (kd, k = 3 plus the texture id: 4 columns) and
    the envmap's."""
    n = config["width"] * config["height"]
    m = len(config["materials"]["kind"])
    eh, ew = config["envmap"]["height"], config["envmap"]["width"]
    return sum(material_adjoint_s(f, m, 4) + envmap_adjoint_s(f, eh, ew)
               for f in bounce_fronts(n, render["max_depth"],
                                      render["bounce_budget_fracs"]))
