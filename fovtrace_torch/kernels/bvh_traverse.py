"""Packet BVH traversal (counterpart of `fovtrace/kernels/bvh_traverse.py`),
the `intersect_backend="bvh"` closest hit and shadow attenuation.

Rays go in packets (default 1024). Each packet walks the scene's flat
BVH (`Scene.with_bvh`) with one stack of its own: it pops a node, culls
it when no ray of the packet can enter its box before its current best
hit, pushes the children of an inner node (right, then left, so the left
is taken first) and tests every ray of the packet against a leaf's
triangles in blocks of LEAF_BLOCK. All packets step together, one node
each per step, until every stack is empty; a packet whose stack is empty
does nothing. The nodes each packet visits, in their order, and so its
ties, are the reference's.

Plain PyTorch by design: the reference computes this in XLA, outside any
Pallas kernel, and `auto` never selects it. Results are detached, as the
reference's stop_gradient leaves them; `intersect.refine_hit_v`
recomputes the winner's (t, u, v) for autograd.
"""

from __future__ import annotations

import torch

from fovtrace_torch import kernels
from fovtrace_torch.core import vec
from fovtrace_torch.core.vec import Vec3
from fovtrace_torch.kernels.intersect import BIG_T, DET_EPS, Hit, _rays

LEAF_BLOCK = 16


def _packets(a: torch.Tensor, n: int, pk: int, fill: float) -> torch.Tensor:
    """[N, ...] -> [N / pk, pk, ...], padded with `fill`."""
    pad = (-n) % pk
    if pad:
        a = torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                     dtype=a.dtype, device=a.device)])
    return a.reshape(-1, pk, *a.shape[1:])


def _leaf_block(scene, s, active, o, d, tmin, tmax, best):
    """One block of LEAF_BLOCK triangles from leaf position s [P] against
    each active packet's rays [P, pk, 3]; returns the updated best."""
    bt, btri, bu, bv = best
    # a block past its leaf's end (every packet steps max-leaf blocks) may
    # run past the last triangle: clamped, as the reference's dynamic_slice
    # clamps, and masked off by `active`
    ids = (s[:, None] + torch.arange(LEAF_BLOCK, device=s.device)
           ).clamp_max(scene.v0.shape[0] - 1)                   # [P, B]
    tri = lambda a: a[ids][:, None]                             # [P,1,B,3]
    v0, e1, e2 = tri(scene.v0), tri(scene.e1), tri(scene.e2)
    od, dd = o[:, :, None], d[:, :, None]                       # [P,pk,1,3]
    pvec = torch.linalg.cross(dd, e2, dim=-1)           # [P,pk,B,3]
    det = (e1 * pvec).sum(-1)
    ok_det = det.abs() > DET_EPS
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tvec = od - v0
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    v = (dd * qvec).sum(-1) * inv_det
    t = (e2 * qvec).sum(-1) * inv_det
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > tmin[..., None]) & (t < tmax[..., None])
          & active[:, None, None])
    t = torch.where(ok, t, BIG_T)
    j = torch.argmin(t, dim=2, keepdim=True)        # the first of equal t
    nt = t.gather(2, j)[..., 0]
    better = nt < bt
    return (torch.where(better, nt, bt),
            torch.where(better, (s[:, None] + j[..., 0]).to(torch.int32),
                        btri),
            torch.where(better, u.gather(2, j)[..., 0], bu),
            torch.where(better, v.gather(2, j)[..., 0], bv))


def _closest(scene, ro: Vec3, rd: Vec3, t_min, t_max, packet: int) -> Hit:
    if not scene.has_bvh:
        raise ValueError("the bvh backend needs a scene with a BVH "
                         "(Scene.with_bvh)")
    n = ro.x.shape[0]
    dev = ro.x.device
    tmin, tmax = _rays(n, t_min, t_max, dev)
    pk = min(packet, n)
    o = _packets(torch.stack(list(ro), -1), n, pk, 0.0)         # [P,pk,3]
    d = _packets(torch.stack(list(rd), -1), n, pk, 1.0)
    tmin = _packets(tmin, n, pk, 0.0)
    tmax = _packets(tmax, n, pk, -1.0)
    p = o.shape[0]
    inv_d = 1.0 / torch.where(d.abs() < 1e-12,
                              torch.where(d < 0, -1e-12, 1e-12), d)
    nmin, nmax = scene.bvh_nodes_min, scene.bvh_nodes_max
    left, right = scene.bvh_left.long(), scene.bvh_right.long()
    is_leaf = scene.bvh_leaf == 1
    # leaves hold a multiple of LEAF_BLOCK triangles: one block but for
    # leaves of coincident centroids
    nblocks = int((right[is_leaf] + LEAF_BLOCK - 1).max()) // LEAF_BLOCK

    depth = max(int(scene.bvh_max_stack), 2)
    stack = torch.zeros((p, depth + 1), dtype=torch.int64, device=dev)
    sp = torch.ones((p,), dtype=torch.int64, device=dev)   # root at 0
    ar = torch.arange(p, device=dev)
    best = (torch.full((p, pk), BIG_T, device=dev),
            torch.full((p, pk), -1, dtype=torch.int32, device=dev),
            torch.zeros((p, pk), device=dev),
            torch.zeros((p, pk), device=dev))
    while True:
        alive = sp > 0
        if not bool(alive.any()):
            break
        sp = sp - alive.long()
        node = stack[ar, sp.clamp_max(depth)]
        lo = (nmin[node][:, None] - o) * inv_d
        hi = (nmax[node][:, None] - o) * inv_d
        tenter = torch.maximum(torch.minimum(lo, hi).amax(-1), tmin)
        texit = torch.minimum(torch.maximum(lo, hi).amin(-1),
                              torch.minimum(tmax, best[0]))
        entered = alive & (tenter <= texit).any(-1)
        leaf = entered & is_leaf[node]
        inner = entered & ~is_leaf[node]
        # an inner node's children: right below, left on top
        at0, at1 = sp.clamp_max(depth), (sp + 1).clamp_max(depth)
        stack[ar, at0] = torch.where(inner, right[node], stack[ar, at0])
        stack[ar, at1] = torch.where(inner, left[node], stack[ar, at1])
        sp = sp + 2 * inner.long()
        start = left[node]
        count = right[node]
        for i in range(nblocks):
            best = _leaf_block(scene, start + i * LEAF_BLOCK,
                               leaf & (i * LEAF_BLOCK < count), o, d, tmin,
                               tmax, best)
    bt, btri, bu, bv = (a.reshape(-1)[:n] for a in best)
    btri = torch.where(bt < BIG_T, btri, -1)
    return Hit(t=bt, tri=btri, u=bu, v=bv)


@torch.no_grad()
def intersect_bvh(scene, ro: Vec3, rd: Vec3, t_min, t_max,
                  packet: int = 1024) -> Hit:
    """Closest hit of SoA rays by packet BVH traversal; needs
    scene.has_bvh."""
    kernels.CALLS["intersect_bvh"] += 1
    return _closest(scene, ro, rd, t_min, t_max, packet)


@torch.no_grad()
def occlusion_bvh(scene, ro: Vec3, rd: Vec3, t_min, t_max,
                  packet: int = 1024) -> Vec3:
    """RGB shadow attenuation through the BVH, with the reference's
    semantics: up to four closest hits along the ray, an opaque one
    blocks it, each refractive one multiplies in its Fresnel
    transmission (1 - schlick(|n.d|, 5, 1 - shadow attenuation, 1))."""
    from fovtrace_torch.scene.scene import MATL_REFRACTION

    kernels.CALLS["occlusion_bvh"] += 1
    n = ro.x.shape[0]
    tmin, tmax = _rays(n, t_min, t_max, ro.x.device)
    mats = scene.materials
    atten = torch.ones((n, 3), device=ro.x.device)
    cur_tmin = tmin
    for _ in range(4):
        hit = _closest(scene, ro, rd, cur_tmin, tmax, packet)
        found = hit.tri >= 0
        tri = hit.tri.clamp_min(0).long()
        mat = torch.where(found, scene.mat_id[tri], -1)
        safe = mat.clamp_min(0).long()
        transparent = torch.where(mat >= 0, mats.kind[safe], -1) \
            == MATL_REFRACTION
        gn = vec.cross(vec.from_rows(scene.e1[tri]),
                       vec.from_rows(scene.e2[tri]))
        gn = gn * (1.0 / torch.clamp_min(vec.length(gn), 1e-20))
        ndi = vec.dot(rd, gn).abs()
        c5 = torch.clamp(1.0 - ndi, 0.0, 1.0) ** 5
        sa = mats.shadow_attenuation[safe]
        trans = torch.clamp(1.0 - ((1.0 - sa) + sa * c5[:, None]), 0.0, 1.0)
        atten = torch.where((found & ~transparent)[:, None], 0.0, atten)
        atten = torch.where((found & transparent)[:, None], atten * trans,
                            atten)
        cur_tmin = torch.where(found, hit.t + 1e-4, tmax + 1.0)
    return vec.from_rows(atten)
