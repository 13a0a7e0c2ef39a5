"""Structure-of-arrays 3-vectors (counterpart of `fovtrace/core/vec.py`).

`Vec3` is a NamedTuple of three same-shaped tensors. It is the public
layout of every ported function: wavefront ray state has [N] components,
planar images [H, W] components. Keeping the reference's layout means
parity tests compare like with like, component by component.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from reference import mathx
from reference.mathx import sqrt_rn


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # Vec3 op Vec3 is componentwise; Vec3 op tensor/scalar broadcasts
    # the operand over all three components
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    @property
    def shape(self):
        return self.x.shape

    def map(self, fn):
        return Vec3(fn(self.x), fn(self.y), fn(self.z))


# ------------------------------------------------------------ constructors
def of(v: torch.Tensor) -> Vec3:
    """Length-3 tensor -> Vec3 of 0-d tensors (broadcasts in arithmetic)."""
    return Vec3(v[..., 0], v[..., 1], v[..., 2])


def splat(v: torch.Tensor, shape) -> Vec3:
    """Broadcast a length-3 tensor to a Vec3 of `shape` components."""
    return Vec3(v[..., 0].expand(shape), v[..., 1].expand(shape),
                v[..., 2].expand(shape))


def from_rows(a: torch.Tensor) -> Vec3:
    """[..., 3] rows -> Vec3."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def to_rows(v: Vec3) -> torch.Tensor:
    """Vec3 -> [..., 3] rows."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def zeros(shape, device) -> Vec3:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return Vec3(z, z, z)


def full(shape, value, device) -> Vec3:
    f = torch.full(shape, value, dtype=torch.float32, device=device)
    return Vec3(f, f, f)


# ------------------------------------------------------------------ algebra
# The reference's compiled code contracts a product that feeds an add or
# a subtract into one fused multiply-add (XLA's CPU backend fuses the
# first operand's product when both are products); `dot`, `cross` and
# `fma` round as it does.
def fma(a: Vec3, b, c) -> Vec3:
    """Componentwise a * b + c with one rounding; b and c may be tensors."""
    b3 = b if isinstance(b, Vec3) else Vec3(b, b, b)
    c3 = c if isinstance(c, Vec3) else Vec3(c, c, c)
    return Vec3(mathx.fma(a.x, b3.x, c3.x), mathx.fma(a.y, b3.y, c3.y),
                mathx.fma(a.z, b3.z, c3.z))


def dot(a: Vec3, b: Vec3) -> torch.Tensor:
    return mathx.fma(a.z, b.z, mathx.fma(a.x, b.x, a.y * b.y))


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        mathx.fma(a.y, b.z, -(a.z * b.y)),
        mathx.fma(a.z, b.x, -(a.x * b.z)),
        mathx.fma(a.x, b.y, -(a.y * b.x)),
    )


def length(v: Vec3, eps: float = 0.0) -> torch.Tensor:
    return sqrt_rn(dot(v, v) + eps)


def norm(v: Vec3, eps: float = 1e-20) -> torch.Tensor:
    return sqrt_rn(torch.clamp_min(dot(v, v), eps))


def normalize(v: Vec3, eps: float = 1e-20) -> Vec3:
    return v * (1.0 / norm(v, eps))


def where(m: torch.Tensor, a, b) -> Vec3:
    """Componentwise select; `a`/`b` may be Vec3 or scalars."""
    ax, ay, az = (a.x, a.y, a.z) if isinstance(a, Vec3) else (a, a, a)
    bx, by, bz = (b.x, b.y, b.z) if isinstance(b, Vec3) else (b, b, b)
    return Vec3(torch.where(m, ax, bx), torch.where(m, ay, by),
                torch.where(m, az, bz))


def abs_(v: Vec3) -> Vec3:
    return Vec3(v.x.abs(), v.y.abs(), v.z.abs())


def exp(v: Vec3) -> Vec3:
    return Vec3(torch.exp(v.x), torch.exp(v.y), torch.exp(v.z))


def max3(v: Vec3) -> torch.Tensor:
    return torch.maximum(torch.maximum(v.x, v.y), v.z)


# ------------------------------------------------------------- shading math
def reflect(i: Vec3, n: Vec3) -> Vec3:
    return fma(-n, 2.0 * dot(i, n), i)


def faceforward(n: Vec3, i: Vec3, nref: Vec3) -> Vec3:
    return where(dot(nref, i) < 0.0, -n, n)


def refract(i: Vec3, n: Vec3, eta_ratio: torch.Tensor):
    """Snell refraction; returns (direction, total-internal-reflection
    mask). TIR lanes get a zero direction; the sqrt argument is clamped
    there so the backward pass stays NaN-free."""
    cosi = dot(i, n)
    entering = cosi < 0.0
    nn = where(entering, n, -n)
    eta = torch.where(entering, 1.0 / eta_ratio, eta_ratio)
    ci = cosi.abs()
    k = mathx.fma(-(eta * eta), mathx.fma(-ci, ci, 1.0), 1.0)
    tir = k <= 0.0
    k_safe = torch.where(tir, 1.0, k)
    t = fma(i, eta, nn * mathx.fma(eta, ci, -sqrt_rn(k_safe)))
    return where(tir, 0.0, normalize(t)), tir


def schlick_rgb(cos_theta: torch.Tensor, reflectivity_n: Vec3) -> Vec3:
    """RGB Schlick: r = n + (1-n)(1-cos)^5."""
    c = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    c5 = c * c
    c5 = c5 * c5 * c
    return fma(1.0 - reflectivity_n, c5, reflectivity_n)


def onb(n: Vec3):
    """Branchless Frisvad orthonormal basis -> (tangent, bitangent)."""
    s = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t = Vec3(mathx.fma(s * n.x * n.x, a, 1.0), s * b, -s * n.x)
    bt = Vec3(b, mathx.fma(n.y * n.y, a, s), -n.y)
    return t, bt


def to_world(lx, ly, lz, n: Vec3) -> Vec3:
    """Local (+Z = n) direction components -> world."""
    t, b = onb(n)
    return fma(n, lz, fma(t, lx, b * ly))


def cosine_sample_hemisphere(z1, z2):
    """Local-frame cosine-weighted hemisphere sample (x, y, z)."""
    r = sqrt_rn(z1)
    phi = (2.0 * math.pi) * z2
    return r * torch.cos(phi), r * torch.sin(phi), sqrt_rn(
        torch.clamp_min(1.0 - z1, 0.0))


def luminance(v: Vec3) -> torch.Tensor:
    return mathx.fma(0.11, v.z, mathx.fma(0.30, v.x, 0.59 * v.y))


def mean_reduce(v: Vec3) -> torch.Tensor:
    """Scalar mean over all components and elements (the bench's loss)."""
    return (torch.mean(v.x) + torch.mean(v.y) + torch.mean(v.z)) / 3.0


def matvec(m: torch.Tensor, v: Vec3, w=None):
    """Apply a 4x4 (or 3x3) matrix to SoA points: returns Vec3 (and w'
    for a 4x4 matrix, with w = 1 when not given)."""
    ox = m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z
    oy = m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z
    oz = m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z
    if m.shape[0] == 3:
        return Vec3(ox, oy, oz)
    if w is None:
        w = 1.0
    ox = ox + m[0, 3] * w
    oy = oy + m[1, 3] * w
    oz = oz + m[2, 3] * w
    ow = m[3, 0] * v.x + m[3, 1] * v.y + m[3, 2] * v.z + m[3, 3] * w
    return Vec3(ox, oy, oz), ow
