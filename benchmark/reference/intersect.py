"""Ray / triangle-soup intersection, plain PyTorch: the closest hit and
the shadow attenuation through `reference.cluster`'s plain walks, then
(t, u, v) of the winner recomputed with autograd-visible tensor ops.
"""

from __future__ import annotations

import dataclasses

import torch

from reference import mathx, vec
from reference.vec import Vec3

BIG_T = 1e30
DET_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Hit:
    t: torch.Tensor    # [N] distance (BIG_T on a miss)
    tri: torch.Tensor  # [N] int32 triangle id (-1 on a miss)
    u: torch.Tensor    # [N] barycentric u
    v: torch.Tensor    # [N] barycentric v

    @property
    def valid(self) -> torch.Tensor:
        return self.tri >= 0


def _raw_hit(scene, ro: Vec3, rd: Vec3, t_min, t_max) -> Hit:
    """Closest hit, detached."""
    from reference import cluster

    d = lambda v: v.map(torch.Tensor.detach)
    return cluster.intersect_cluster(scene, d(ro), d(rd), t_min, t_max)


def occlusion_v(scene, ro: Vec3, rd: Vec3, t_min, t_max) -> Vec3:
    """Shadow attenuation (detached: visibility is locally constant)."""
    from reference import cluster

    d = lambda v: v.map(torch.Tensor.detach)
    return cluster.occlusion_cluster(scene, d(ro), d(rd), t_min, t_max)


# --------------------------------------------------------------- shading IO
class RowGather(torch.autograd.Function):
    """(table [M, K], ids [N]) -> table.index_select(0, ids), whose
    adjoint sums the [N, K] cotangent into the table's rows in float64.
    Autograd's own adjoint (index_add_) adds millions of float32 values
    into a handful of rows one atomic add at a time on the card, which
    at 3840x2176 drops 1.5% of a row's sum; in float64 the sum keeps
    every digit that float32 can hold."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape = table.shape
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=torch.float64, device=g.device)
        return acc.index_add_(0, ids, g.double()).to(g.dtype), None


def material_lookup_v(materials, safe_mat: torch.Tensor, columns) -> list:
    """Fetch per-material columns for each ray from the concatenated
    [M, K] table (a row gather; its adjoint a float64 sum, RowGather).
    `columns` lists (name, width): width 3 returns a Vec3, width 1 an [N]
    tensor."""
    cols = []
    for name, width in columns:
        col = getattr(materials, name).to(torch.float32)
        cols.append(col[:, None] if col.ndim == 1 else col)
    vals = RowGather.apply(torch.cat(cols, dim=1), safe_mat.long()).T  # [K, N]
    out = []
    off = 0
    for _, width in columns:
        if width == 1:
            out.append(vals[off])
        elif width == 3:
            out.append(Vec3(vals[off], vals[off + 1], vals[off + 2]))
        else:
            out.append(vals[off:off + width])
        off += width
    return out


def _surface(scene, ro: Vec3, rd: Vec3, hit: Hit, at: torch.Tensor):
    """Surface attributes at refined hits from gathered [19, N]
    attribute rows (n0 n1 n2 gn uv0 uv1 uv2 mat_id)."""
    gv = lambda r: Vec3(at[r], at[r + 1], at[r + 2])
    w = 1.0 - hit.u - hit.v
    n0, n1, n2 = gv(0), gv(3), gv(6)
    # barycentric sums and the hit point, contracted as the reference's
    # compiled code contracts them (vec.fma)
    n_sh = vec.normalize(vec.fma(n2, hit.v, vec.fma(n0, w, n1 * hit.u)))
    bary = lambda r: mathx.fma(at[r + 4], hit.v,
                               mathx.fma(at[r], w, at[r + 2] * hit.u))
    u_tex, v_tex = bary(12), bary(13)
    valid = hit.valid
    mat_id = torch.where(valid, at[18].to(torch.int32), -1)
    t_safe = torch.where(valid, hit.t, 0.0)
    point = vec.fma(rd, t_safe, ro)

    safe_mat = mat_id.clamp_min(0)
    kd, tex_id_f = material_lookup_v(scene.materials, safe_mat,
                                     [("kd", 3), ("texture_id", 1)])
    tex_id = tex_id_f.to(torch.int64)
    ntex, th, tw = scene.textures.shape[:3]
    if ntex > 1 or th * tw > 1:
        # nearest-texel albedo lookup (1x1 placeholder atlases skip it)
        tx = torch.clamp(torch.remainder(u_tex, 1.0) * tw, 0, tw - 1).long()
        ty = torch.clamp(torch.remainder(v_tex, 1.0) * th, 0, th - 1).long()
        ti = torch.clamp(tex_id, 0, ntex - 1)
        texel = vec.from_rows(scene.textures.reshape(-1, 3)[
            (ti * th + ty) * tw + tx])
        kd = vec.where(tex_id >= 0, kd * texel, kd)
    return {"point": point, "normal": n_sh, "gnormal": gv(9),
            "u_tex": u_tex, "v_tex": v_tex, "mat_id": mat_id, "kd": kd,
            "t_safe": t_safe}


def intersect_surface_v(scene, ro: Vec3, rd: Vec3, t_min, t_max):
    """Closest hit + refine + surface attributes, with one [N, 28] row
    gather of geometry and attributes for the winning triangles."""
    raw = _raw_hit(scene, ro, rd, t_min, t_max)
    tri = raw.tri.clamp_min(0).long()
    comb = torch.cat([scene.v0, scene.e1, scene.e2, scene.tri_attr[:, :19]],
                     dim=1)
    g = comb[tri].T                                       # [28, N]
    gv = lambda r: Vec3(g[r], g[r + 1], g[r + 2])
    v0, e1, e2 = gv(0), gv(3), gv(6)
    pvec = vec.cross(rd, e2)
    det = vec.dot(e1, pvec)
    inv_det = torch.where(det.abs() > DET_EPS, 1.0 / det, 0.0)
    tvec = ro - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(rd, qvec) * inv_det
    t = vec.dot(e2, qvec) * inv_det
    valid = raw.tri >= 0
    hit = Hit(t=torch.where(valid, t, BIG_T), tri=raw.tri,
              u=torch.where(valid, u, 0.0), v=torch.where(valid, v, 0.0))
    return hit, _surface(scene, ro, rd, hit, g[9:])
