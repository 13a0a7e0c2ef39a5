"""Ray / triangle-soup intersection (counterpart of
`fovtrace/kernels/intersect.py`).

Backends, chosen by `RenderConfig.intersect_backend`:
  cluster  `kernels.cluster_isect`: per 256-ray block, a front-to-back
           walk over the live 128-triangle clusters — the CUDA kernels
           on CUDA tensors, their plain versions on CPU tensors
  brute    `intersect_brute` / `occlusion_brute`: every ray against
           every triangle, the oracle the kernels are tested against

Traversal results are discrete and come back detached (the counterpart
of the reference's stop_gradient); `refine_hit_v` then recomputes
(t, u, v) of the winning triangle with autograd-visible tensor ops.
"""

from __future__ import annotations

import dataclasses

import torch

from fovtrace_torch import kernels
from fovtrace_torch.core import mathx, vec
from fovtrace_torch.core.vec import Vec3

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


def _rays(n, t_min, t_max, device):
    f = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                  device=device).expand(n)
    return f(t_min), f(t_max)


def _mt_block(ro: Vec3, rd: Vec3, v0: Vec3, e1: Vec3, e2: Vec3, t_min,
              t_max):
    """Moller-Trumbore for [C] rays x [B] triangles -> (t, u, v, hit)
    [C,B]. Rays are Vec3 of [C,1] components, triangles of [1,B]."""
    pvec = vec.cross(rd, e2)
    det = vec.dot(e1, pvec)
    inv_det = torch.where(det.abs() > DET_EPS, 1.0 / det, 0.0)
    tvec = ro - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(rd, qvec) * inv_det
    t = vec.dot(e2, qvec) * inv_det
    hit = ((det.abs() > DET_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return t, u, v, hit


def _tri_blocks(scene, tri_block):
    """Triangle blocks of at most `tri_block` as Vec3s of [1,B]."""
    nt = scene.num_triangles
    for base in range(0, nt, tri_block):
        sl = slice(base, min(base + tri_block, nt))
        row = lambda a: vec.from_rows(a[sl][None])
        yield base, sl, row(scene.v0), row(scene.e1), row(scene.e2)


@torch.no_grad()
def intersect_brute(scene, ro: Vec3, rd: Vec3, t_min, t_max,
                    tri_block: int = 512, ray_chunk: int = 2048) -> Hit:
    """Closest hit over all triangles; ties go to the lowest triangle id.
    Memory is bounded by ray chunks x triangle blocks."""
    kernels.CALLS["intersect_brute"] += 1
    n = ro.x.shape[0]
    dev = ro.x.device
    tmin, tmax = _rays(n, t_min, t_max, dev)
    out_t = torch.full((n,), BIG_T, dtype=torch.float32, device=dev)
    out_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    out_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    for r0 in range(0, n, ray_chunk):
        rs = slice(r0, min(r0 + ray_chunk, n))
        co = ro.map(lambda a: a[rs][:, None])
        cd = rd.map(lambda a: a[rs][:, None])
        best_t = torch.full((rs.stop - rs.start,), BIG_T, device=dev)
        best_i = torch.full_like(best_t, -1, dtype=torch.int32)
        best_u = torch.zeros_like(best_t)
        best_v = torch.zeros_like(best_t)
        for base, _, v0, e1, e2 in _tri_blocks(scene, tri_block):
            t, u, v, hit = _mt_block(co, cd, v0, e1, e2, tmin[rs][:, None],
                                     tmax[rs][:, None])
            tm = torch.where(hit, t, BIG_T)
            k = torch.argmin(tm, dim=1, keepdim=True)
            bt = tm.gather(1, k)[:, 0]
            better = bt < best_t      # strict: the earlier block wins ties
            best_t = torch.where(better, bt, best_t)
            best_i = torch.where(better, (base + k[:, 0]).to(torch.int32),
                                 best_i)
            best_u = torch.where(better, u.gather(1, k)[:, 0], best_u)
            best_v = torch.where(better, v.gather(1, k)[:, 0], best_v)
        out_t[rs], out_i[rs], out_u[rs], out_v[rs] = (best_t, best_i,
                                                      best_u, best_v)
    return Hit(t=out_t, tri=out_i, u=out_u, v=out_v)


@torch.no_grad()
def occlusion_brute(scene, ro: Vec3, rd: Vec3, t_min, t_max,
                    tri_block: int = 512, ray_chunk: int = 2048) -> Vec3:
    """Any-hit RGB shadow attenuation: an opaque occluder sets it to 0,
    a refractive one multiplies in 1 - schlick(|n.d|, 5, 1 - shadow
    attenuation, 1) per channel."""
    from fovtrace_torch.scene.scene import MATL_REFRACTION

    kernels.CALLS["occlusion_brute"] += 1
    n = ro.x.shape[0]
    dev = ro.x.device
    tmin, tmax = _rays(n, t_min, t_max, dev)
    mats = scene.materials
    valid = scene.mat_id >= 0
    safe = scene.mat_id.clamp_min(0).long()
    kind = torch.where(valid, mats.kind[safe], -1)
    transparent = kind == MATL_REFRACTION
    satt = torch.where(valid[:, None], mats.shadow_attenuation[safe], 1.0)
    gn = vec.from_rows(scene.e1)
    gn = vec.cross(gn, vec.from_rows(scene.e2))
    gn = gn * (1.0 / torch.clamp_min(vec.length(gn), 1e-20))

    out = torch.ones((n, 3), dtype=torch.float32, device=dev)
    for r0 in range(0, n, ray_chunk):
        rs = slice(r0, min(r0 + ray_chunk, n))
        co = ro.map(lambda a: a[rs][:, None])
        cd = rd.map(lambda a: a[rs][:, None])
        acc = torch.ones((rs.stop - rs.start, 3), device=dev)
        for _, sl, v0, e1, e2 in _tri_blocks(scene, tri_block):
            _, _, _, hit = _mt_block(co, cd, v0, e1, e2, tmin[rs][:, None],
                                     tmax[rs][:, None])
            hit = hit & valid[sl][None]
            ndi = vec.dot(cd, gn.map(lambda a: a[sl][None])).abs()
            c5 = torch.clamp(1.0 - ndi, 0.0, 1.0) ** 5
            sa = satt[sl][None]                                # [1,B,3]
            trans = 1.0 - ((1.0 - sa) + sa * c5[..., None])
            factor = torch.where(
                hit[..., None],
                torch.where(transparent[sl][None, :, None],
                            torch.clamp(trans, 0.0, 1.0), 0.0),
                1.0)
            acc = acc * torch.prod(factor, dim=1)
        out[rs] = acc
    return vec.from_rows(out)


# ------------------------------------------------------------- dispatchers
def _pick_backend(backend: str) -> str:
    return "cluster" if backend == "auto" else backend


def _raw_hit(scene, ro: Vec3, rd: Vec3, t_min, t_max, backend: str) -> Hit:
    """Closest hit, detached: cluster kernels or the brute oracle."""
    d = lambda v: v.map(torch.Tensor.detach)
    if _pick_backend(backend) == "cluster":
        from fovtrace_torch.kernels import cluster_isect

        return cluster_isect.intersect_cluster(scene, d(ro), d(rd), t_min,
                                               t_max)
    return intersect_brute(scene, d(ro), d(rd), t_min, t_max)


def refine_hit_v(scene, ro: Vec3, rd: Vec3, hit: Hit) -> Hit:
    """Recompute (t, u, v) for the already-found triangle with tensor
    ops autograd can follow (rays and scene geometry)."""
    tri = hit.tri.clamp_min(0).long()
    g = torch.cat([scene.v0, scene.e1, scene.e2], dim=1)[tri].T  # [9,N]
    v0 = Vec3(g[0], g[1], g[2])
    e1 = Vec3(g[3], g[4], g[5])
    e2 = Vec3(g[6], g[7], g[8])
    pvec = vec.cross(rd, e2)
    det = vec.dot(e1, pvec)
    inv_det = torch.where(det.abs() > DET_EPS, 1.0 / det, 0.0)
    tvec = ro - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(rd, qvec) * inv_det
    t = vec.dot(e2, qvec) * inv_det
    valid = hit.tri >= 0
    return Hit(t=torch.where(valid, t, BIG_T), tri=hit.tri,
               u=torch.where(valid, u, 0.0), v=torch.where(valid, v, 0.0))


def intersect_v(scene, ro: Vec3, rd: Vec3, t_min, t_max,
                backend: str = "auto") -> Hit:
    """Closest-hit dispatcher; t/u/v are refined on the winner."""
    return refine_hit_v(scene, ro, rd,
                        _raw_hit(scene, ro, rd, t_min, t_max, backend))


def occlusion_v(scene, ro: Vec3, rd: Vec3, t_min, t_max,
                backend: str = "auto") -> Vec3:
    """Shadow-attenuation dispatcher (visibility is locally constant, so
    the result is detached)."""
    d = lambda v: v.map(torch.Tensor.detach)
    if _pick_backend(backend) == "cluster":
        from fovtrace_torch.kernels import cluster_isect

        return cluster_isect.occlusion_cluster(scene, d(ro), d(rd), t_min,
                                               t_max)
    return occlusion_brute(scene, d(ro), d(rd), t_min, t_max)


# --------------------------------------------------------------- shading IO
def material_lookup_v(materials, safe_mat: torch.Tensor, columns) -> list:
    """Fetch per-material columns for each ray with one row gather from
    the concatenated [M, K] table. `columns` lists (name, width): width 3
    returns a Vec3, width 1 an [N] tensor."""
    cols = []
    for name, width in columns:
        col = getattr(materials, name).to(torch.float32)
        cols.append(col[:, None] if col.ndim == 1 else col)
    vals = torch.cat(cols, dim=1)[safe_mat.long()].T    # [K, N]
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


def hit_surface_v(scene, ro: Vec3, rd: Vec3, hit: Hit) -> dict:
    """Interpolated surface attributes at hits: point, shading normal,
    geometric normal, texture uv, mat_id, kd, t_safe."""
    at = scene.tri_attr[hit.tri.clamp_min(0).long()].T     # [24, N]
    return _surface(scene, ro, rd, hit, at)


def intersect_surface_v(scene, ro: Vec3, rd: Vec3, t_min, t_max,
                        backend: str = "auto"):
    """Closest hit + refine + surface attributes, with one [N, 28] row
    gather of geometry and attributes for the winning triangles."""
    raw = _raw_hit(scene, ro, rd, t_min, t_max, backend)
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
