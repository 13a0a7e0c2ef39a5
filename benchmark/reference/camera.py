"""Pinhole/thin-lens camera.

A frozen dataclass of float32 tensors on one device. Matrices are built
from the pose on every call, so the pose stays an ordinary tensor that
autograd can see.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from reference import mathx
from reference import vec as vecm

PM_PERSPECTIVE = "perspective"
PM_ORTHO = "ortho"
PM_ORTHO_WIDTH = "ortho_width"
PM_ORTHO_HEIGHT = "ortho_height"


def _lu_host(m: torch.Tensor):
    """LAPACK sgetrf of a 4x4 on the host: (lu, perm) with m[perm] = L U.
    On a CUDA tensor it waits for the device."""
    from scipy.linalg import lapack

    lu, piv, info = lapack.sgetrf(m.detach().cpu().numpy().astype(np.float32))
    if info != 0:
        raise ValueError(f"singular camera matrix (sgetrf info {info})")
    perm = np.arange(4)
    for i, p in enumerate(piv):
        perm[i], perm[p] = perm[p], perm[i]
    return lu, perm


def _lu_inverse(lu, perm) -> np.ndarray:
    """A^-1 from A's factors: two BLAS strsm solves of the permuted
    identity."""
    from scipy.linalg import blas

    y = blas.strsm(1.0, lu, np.eye(4, dtype=np.float32)[perm], side=0,
                   lower=1, diag=1)
    return blas.strsm(1.0, lu, y, side=0, lower=0, diag=0)


class _Inv4(torch.autograd.Function):
    """A^-1 with the reference's adjoint: A_bar = -solve(A^T, X_bar) X^T,
    the transposed solve run on A's LU factors. Forming the adjoint with
    an explicit inverse instead moves the eye gradient past the goldens'
    tolerance (the matrix is ill-conditioned)."""

    @staticmethod
    def forward(ctx, m):
        lu, perm = _lu_host(m)
        x = torch.as_tensor(_lu_inverse(lu, perm), device=m.device)
        ctx.save_for_backward(x)
        ctx.lu = (lu, perm)
        return x

    @staticmethod
    def backward(ctx, g):
        from scipy.linalg import blas

        (x,) = ctx.saved_tensors
        lu, perm = ctx.lu
        gh = g.detach().cpu().numpy().astype(np.float32)
        # A^T = U^T L^T P^T: solve with U^T, then with the unit L^T, then
        # undo the row permutation
        z = blas.strsm(1.0, lu, gh, side=0, lower=0, trans_a=1, diag=0)
        w = blas.strsm(1.0, lu, z, side=0, lower=1, trans_a=1, diag=1)
        y = np.empty_like(w)
        y[perm] = w
        return -(torch.as_tensor(y, device=g.device) @ x.T)


def inv4(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a 4x4 float32 matrix, rounded as the reference rounds it.

    The MVP matrix is ill-conditioned (near 0.1, far 1000), so float32
    inverses from different LU codes differ by ~1e-5 relative, which
    moves primary-ray hit points by ~1e-4. The reference inverts with
    LAPACK sgetrf and two BLAS strsm solves on the host; this does the
    same through scipy, a 4x4 round trip to the host, and a second one in
    the backward pass when `m` requires grad (_Inv4)."""
    if m.requires_grad:
        return _Inv4.apply(m)
    return torch.as_tensor(_lu_inverse(*_lu_host(m)), device=m.device)


@dataclasses.dataclass(frozen=True)
class Camera:
    eye: torch.Tensor      # [3]
    target: torch.Tensor   # [3]
    up: torch.Tensor       # [3]
    fov_y: torch.Tensor    # 0-d: degrees (perspective) or world extent (ortho)
    near: torch.Tensor     # 0-d
    far: torch.Tensor      # 0-d
    mode: str = PM_PERSPECTIVE

    @classmethod
    def create(cls, eye, target, up=(0.0, 1.0, 0.0), fov_y=45.0, near=0.1,
               far=1000.0, mode=PM_PERSPECTIVE, device="cuda") -> "Camera":
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                        device=device)
        return cls(eye=f32(eye), target=f32(target), up=f32(up),
                   fov_y=f32(fov_y), near=f32(near), far=f32(far), mode=mode)

    @property
    def device(self) -> torch.device:
        return self.eye.device

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    # --- matrices -------------------------------------------------------
    def view_matrix(self) -> torch.Tensor:
        """Right-handed lookAt."""
        f = mathx.normalize(self.target - self.eye)
        s = mathx.normalize(mathx.cross(f, mathx.normalize(self.up)))
        u = mathx.cross(s, f)
        rot = torch.stack([s, u, -f], dim=0)              # [3,3]
        trans = -(rot @ self.eye)
        top = torch.cat([rot, trans[:, None]], dim=1)     # [3,4]
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=self.device)
        return torch.cat([top, bottom], dim=0)

    def proj_matrix(self, aspect: float) -> torch.Tensor:
        """Perspective projection, or one of the three ortho modes."""
        n, fr = self.near, self.far
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        one = zero + 1.0
        if self.mode != PM_PERSPECTIVE:
            v = self.fov_y * 0.5
            if self.mode == PM_ORTHO_HEIGHT:
                y = v
                x = y * aspect
            elif self.mode == PM_ORTHO_WIDTH:
                x = v
                y = x / aspect
            else:
                x = v * aspect if aspect > 1.0 else v
                y = v if aspect > 1.0 else v / aspect
            rows = [[1.0 / x, zero, zero, zero],
                    [zero, 1.0 / y, zero, zero],
                    [zero, zero, -2.0 / (fr - n), -(fr + n) / (fr - n)],
                    [zero, zero, zero, one]]
        else:
            fov_rad = self.fov_y * (math.pi / 180.0)
            f = 1.0 / torch.tan(fov_rad / 2.0)
            rows = [[f / aspect, zero, zero, zero],
                    [zero, f, zero, zero],
                    [zero, zero, (fr + n) / (n - fr), 2.0 * fr * n / (n - fr)],
                    [zero, zero, -one, zero]]
        return torch.stack([torch.stack(r) for r in rows])

    def mvp(self, aspect: float) -> torch.Tensor:
        return self.proj_matrix(aspect) @ self.view_matrix()

    def inv_mvp(self, aspect: float) -> torch.Tensor:
        return inv4(self.mvp(aspect))

    # --- pose helpers ---------------------------------------------------
    def translate(self, delta) -> "Camera":
        d = torch.as_tensor(delta, dtype=torch.float32, device=self.device)
        return self.replace(eye=self.eye + d, target=self.target + d)

    def rotate(self, angle, axis) -> "Camera":
        """Turn the view direction about the eye."""
        q = mathx.quat_from_axis_angle(
            torch.as_tensor(axis, dtype=torch.float32, device=self.device),
            angle)
        return self.replace(
            target=mathx.quat_rotate(q, self.target - self.eye) + self.eye,
            up=mathx.quat_rotate(q, self.up))

    def rotate_around(self, center, angle, axis) -> "Camera":
        """Orbit the eye about `center`."""
        c = torch.as_tensor(center, dtype=torch.float32, device=self.device)
        q = mathx.quat_from_axis_angle(
            torch.as_tensor(axis, dtype=torch.float32, device=self.device),
            angle)
        return self.replace(eye=mathx.quat_rotate(q, self.eye - c) + c,
                            up=mathx.quat_rotate(q, self.up))

    # --- thin-lens depth of field ----------------------------------------
    def basis(self):
        """(view, right, up) camera frame."""
        view = mathx.normalize(self.target - self.eye)
        right = mathx.normalize(mathx.cross(view, mathx.normalize(self.up)))
        up = mathx.normalize(mathx.cross(right, view))
        return view, right, up

    # --- SoA ray generation ---------------------------------------------
    def unproject_v(self, ndc_x, ndc_y, aspect: float):
        """NDC components ([N] or [H,W]) -> (near points Vec3 | None for
        the pinhole, world ray directions Vec3)."""
        inv = self.inv_mvp(aspect)
        col = lambda r: (inv[r, 0] * ndc_x + inv[r, 1] * ndc_y
                         - inv[r, 2] + inv[r, 3])
        w = col(3)
        near = vecm.Vec3(col(0), col(1), col(2)) * (1.0 / w)
        if self.mode != PM_PERSPECTIVE:
            colf = lambda r: (inv[r, 0] * ndc_x + inv[r, 1] * ndc_y
                              + inv[r, 2] + inv[r, 3])
            wf = colf(3)
            far = vecm.Vec3(colf(0), colf(1), colf(2)) * (1.0 / wf)
            return near, vecm.normalize(far - near)
        dirs = vecm.normalize(near - vecm.of(self.eye))
        return None, dirs

    def primary_rays_v(self, width: int, height: int, y0: int = 0,
                       block_h: int | None = None, aspect=None):
        """SoA primary rays for rows [y0, y0 + block_h) (the full frame
        when block_h is None). Returns (origins, dirs), Vec3s of
        [bh, W] components."""
        if aspect is None:
            aspect = float(width) / float(height)
        bh = height if block_h is None else block_h
        dev = self.device
        xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
        ys = (torch.arange(bh, dtype=torch.float32, device=dev)
              + float(y0))[:, None]
        ndc_x = (xs / width * 2.0 - 1.0).expand(bh, width)
        ndc_y = (ys / height * 2.0 - 1.0).expand(bh, width)
        near, dirs = self.unproject_v(ndc_x, ndc_y, aspect)
        if near is None:
            near = vecm.splat(self.eye, (bh, width))
        return near, dirs

    def primary_rays_block(self, width: int, height: int, y0: int,
                           block_h: int, aspect=None):
        """Row-layout primary rays for rows [y0, y0 + block_h) of the
        W x H grid, the training render's rays: (origins, dirs), each
        [block_h, W, 3]. Rounded as the reference's compiled
        `primary_rays_block`: the NDC map is one fused multiply-add by
        2 / size, the homogeneous product sums the x and y terms and then
        the constant column (inv[:, 3] - inv[:, 2]), and the norm is a
        contracted dot product."""
        if aspect is None:
            aspect = float(width) / float(height)
        dev = self.device
        ndc = lambda p, n: mathx.fma(p, float(np.float32(2.0) / np.float32(n)),
                                     -1.0)
        ndc_x = ndc(torch.arange(width, dtype=torch.float32, device=dev),
                    width)[None, :].expand(block_h, width)
        ndc_y = ndc(torch.arange(block_h, dtype=torch.float32, device=dev)
                    + float(y0), height)[:, None].expand(block_h, width)
        inv = self.inv_mvp(aspect)
        world = [(inv[i, 0] * ndc_x + inv[i, 1] * ndc_y)
                 + (inv[i, 3] - inv[i, 2]) for i in range(4)]
        v = vecm.Vec3(*(world[i] / world[3] for i in range(3))) \
            - vecm.of(self.eye)
        n2 = mathx.fma(v.z, v.z, mathx.fma(v.y, v.y, v.x * v.x))
        dirs = vecm.to_rows(v) / mathx.sqrt_rn(torch.clamp_min(n2, 1e-20))[
            ..., None]
        return self.eye.expand(dirs.shape), dirs

    def world_to_screen_v(self, p: vecm.Vec3, width: int, height: int,
                          aspect=None):
        """World points -> (u, v) pixel coordinates in this camera."""
        if aspect is None:
            aspect = float(width) / float(height)
        m = self.mvp(aspect)
        (cx, cy, _), cw = vecm.matvec(m, p)
        safe_w = torch.where(cw.abs() < 1e-20, 1e-20, cw)
        u = (cx / safe_w * width + width) * 0.5
        v = (cy / safe_w * height + height) * 0.5
        return u, v

    def thin_lens_perturb_v(self, dirs: vecm.Vec3, focus_dist, lens_radius,
                            u1, u2):
        """Pinhole directions -> thin-lens (origins, dirs) focused on the
        plane at `focus_dist` along the view axis; the lens point samples
        a disc of radius `lens_radius`."""
        view, right, up = self.basis()
        viewv, rightv, upv = vecm.of(view), vecm.of(right), vecm.of(up)
        eye = vecm.of(self.eye)
        denom = torch.clamp_min(vecm.dot(dirs, viewv), 1e-6)
        focus_pt = eye + dirs * (focus_dist / denom)
        ang = 2.0 * math.pi * u1
        rad = lens_radius * mathx.sqrt_rn(u2)
        lens = eye + rightv * (torch.cos(ang) * rad) + upv * (torch.sin(ang) * rad)
        return lens, vecm.normalize(focus_pt - lens)
