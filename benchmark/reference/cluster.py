"""Cluster ray/triangle intersection, plain PyTorch: the pack, the
schedule, and the closest-hit and occlusion walks.

Triangles are cut into clusters of c = 128 with precomputed AABBs.
Moller-Trumbore is written as four determinants linear in the ray
feature f = [o, d, o x d, 1] (Cramer / Plucker form):

    det   = f . [0,   -n,      0,  0     ]
    t*det = f . [n,    0,      0,  -v0.n ]
    u*det = f . [0,  v0 x e2,  e2, 0     ]
    v*det = f . [0,  e1 x v0, -e1, 0     ]

so one cluster is a [10, 4c] coefficient slab (`compute_pack`). Rays are
packed as [NB, 16, 256] feature blocks (`pack_raysT`); per 256-ray block
an interval-arithmetic bundle-vs-AABB test (`block_liveness`) gives the
live clusters, sorted front to back (`cluster_schedule`), and every
scheduled (block, cluster) pair is one dense float32 product.
"""

from __future__ import annotations

import torch

from reference.config import pin_fp32
from reference.vec import Vec3
from reference.intersect import BIG_T, DET_EPS, Hit

CLUSTER = 128        # minimum triangles per cluster
MAX_CLUSTERS = 4096  # the schedule's id field is 16 bits
MAX_SCHED = 1024     # cap on scheduled entries per ray block
RAY_BLOCK = 256      # rays per schedule bundle (one CUDA block)
NFEAT = 10           # rows of the ray feature that meet the coefficients
KEY_MAX = (1 << 15) - 1

# bytes of one [B, 256, 4c] f32 product the plain versions materialize
_PLAIN_CHUNK_BYTES = 512 << 20


def pick_cluster(t_pad_min: int) -> int:
    """Cluster width: the smallest power-of-two multiple of 128 keeping
    the cluster count <= MAX_CLUSTERS."""
    c = CLUSTER
    while (t_pad_min + c - 1) // c > MAX_CLUSTERS:
        c *= 2
    return c


def pick_members(nc: int) -> int:
    """Clusters per scheduled entry: the smallest power of two keeping
    the entry count <= MAX_SCHED (1 for scenes up to 131k triangles)."""
    m = 1
    while (nc + m - 1) // m > MAX_SCHED:
        m *= 2
    if m > 32:
        raise ValueError("member bitmask holds 32 bits")
    return m


# ----------------------------------------------------------------- packing
def _rowsum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def compute_pack(scene):
    """(coef [NC, 16, 4c], aux [NC, 8, c], clusters [NC, 8]) f32.

    coef columns per cluster: [t_num | det | u_num | v_num], c wide each;
    rows 10-15 are zero. aux rows: transparent flag, shadow attenuation
    rgb, 1/|e1 x e2|, zeros. clusters: AABB min (0:3), max (3:6), zeros.
    Padding triangles have zero coefficients (det = 0, never hit) and
    padding clusters empty AABBs (never live)."""
    from reference.scene import MATL_REFRACTION, host_cross, host_norm

    v0, e1, e2 = scene.v0, scene.e1, scene.e2
    dev = v0.device
    t = v0.shape[0]
    c = pick_cluster(t)
    m = pick_members((t + c - 1) // c)
    pad = (-t) % (c * m)
    padv = lambda a: torch.cat(
        [a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype, device=dev)])
    v0, e1, e2 = padv(v0), padv(e1), padv(e2)
    t_pad = v0.shape[0]
    nc = t_pad // c

    n = host_cross(e1, e2)
    v0xe2 = host_cross(v0, e2)
    e1xv0 = host_cross(e1, v0)
    v0n = _rowsum3(v0 * n)

    coef = torch.zeros((16, t_pad, 4), dtype=torch.float32, device=dev)
    coef[0:3, :, 0] = n.T
    coef[9, :, 0] = -v0n
    coef[3:6, :, 1] = -n.T
    coef[3:6, :, 2] = v0xe2.T
    coef[6:9, :, 2] = e2.T
    coef[3:6, :, 3] = e1xv0.T
    coef[6:9, :, 3] = -e1.T
    coef = (coef.reshape(16, nc, c, 4).permute(1, 0, 3, 2)
            .reshape(nc, 16, 4 * c).contiguous())

    mats = scene.materials
    valid = scene.mat_id >= 0
    safe = scene.mat_id.clamp_min(0).long()
    kind = torch.where(valid, mats.kind[safe], -1)
    transp = torch.cat([(kind == MATL_REFRACTION).to(torch.float32),
                        torch.zeros((pad,), device=dev)])
    sa = torch.where(valid[:, None], mats.shadow_attenuation[safe], 1.0)
    sa = torch.cat([sa, torch.ones((pad, 3), device=dev)])
    inv_n = 1.0 / torch.clamp_min(host_norm(n), 1e-20)
    aux = torch.zeros((8, t_pad), dtype=torch.float32, device=dev)
    aux[0] = transp
    aux[1:4] = sa.T
    aux[4] = inv_n
    aux = aux.reshape(8, nc, c).permute(1, 0, 2).contiguous()

    v0c, e1c, e2c = (a.reshape(nc, c, 3) for a in (v0, e1, e2))
    v1c = v0c + e1c
    v2c = v0c + e2c
    degen = (_rowsum3(e1c * e1c) + _rowsum3(e2c * e2c)) == 0.0
    lo = torch.where(degen[..., None], BIG_T,
                     torch.minimum(torch.minimum(v0c, v1c), v2c))
    hi = torch.where(degen[..., None], -BIG_T,
                     torch.maximum(torch.maximum(v0c, v1c), v2c))
    clusters = torch.zeros((nc, 8), dtype=torch.float32, device=dev)
    clusters[:, 0:3] = lo.amin(dim=1)
    clusters[:, 3:6] = hi.amax(dim=1)
    return coef, aux, clusters


def pack_raysT(ro: Vec3, rd: Vec3, t_min, t_max):
    """SoA rays -> ([NB, 16, 256] feature blocks, N). Rows: o (3), d (3),
    o x d (3), 1, t_min, t_max, 1/d (3), 0. N is padded to whole blocks
    with filler rays d = (1,0,0), t_max = -1 that never hit."""
    n = ro.x.shape[0]
    dev = ro.x.device
    f = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                  device=dev).expand(n)
    # o x d without fused multiply-adds (vec.cross contracts them), as
    # the reference's pack_raysT rounds it when it runs op by op
    w = Vec3(ro.y * rd.z - ro.z * rd.y, ro.z * rd.x - ro.x * rd.z,
             ro.x * rd.y - ro.y * rd.x)
    eps = 1e-12
    inv = lambda d: 1.0 / torch.where(d.abs() < eps,
                                      torch.where(d < 0, -eps, eps), d)
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    raysT = torch.stack([ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, w.x, w.y, w.z,
                         ones, f(t_min), f(t_max), inv(rd.x), inv(rd.y),
                         inv(rd.z), zeros], dim=0)               # [16, N]
    pad = (-n) % RAY_BLOCK
    if pad:
        filler = torch.zeros((16, pad), dtype=torch.float32, device=dev)
        filler[3] = 1.0
        filler[11] = -1.0
        filler[12:15] = 1.0
        raysT = torch.cat([raysT, filler], dim=1)
    nb = raysT.shape[1] // RAY_BLOCK
    return raysT.reshape(16, nb, RAY_BLOCK).permute(1, 0, 2).contiguous(), n


# --------------------------------------------------- block-sparse liveness
def block_liveness(raysT: torch.Tensor, clusters: torch.Tensor):
    """([NB, NC] bool, [NB, NC] f32 entry-t lower bound): can any ray of
    block i hit cluster j? Interval arithmetic over the bundle's origin
    and direction extremes against each cluster's slabs; a direction
    interval straddling zero leaves that axis unconstrained."""
    o_lo = raysT[:, 0:3, :].amin(dim=2)            # [NB,3]
    o_hi = raysT[:, 0:3, :].amax(dim=2)
    d_lo = raysT[:, 3:6, :].amin(dim=2)
    d_hi = raysT[:, 3:6, :].amax(dim=2)
    tmin_lo = raysT[:, 10, :].amin(dim=1)          # [NB]
    tmax_hi = raysT[:, 11, :].amax(dim=1)
    b_lo = clusters[:, 0:3]                        # [NC,3]
    b_hi = clusters[:, 3:6]

    c1 = b_lo[None, :, :] - o_hi[:, None, :]       # [NB,NC,3]
    c2 = b_hi[None, :, :] - o_lo[:, None, :]
    eps = 1e-12
    zero_span = (d_lo[:, None, :] <= eps) & (d_hi[:, None, :] >= -eps)
    safe = lambda d: torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps),
                                 d)
    i1 = (1.0 / safe(d_lo))[:, None, :]
    i2 = (1.0 / safe(d_hi))[:, None, :]
    corners = torch.stack([c1 * i1, c1 * i2, c2 * i1, c2 * i2], dim=0)
    t_lo = torch.where(zero_span, -BIG_T, corners.amin(dim=0))
    t_hi = torch.where(zero_span, BIG_T, corners.amax(dim=0))
    tenter = torch.maximum(t_lo.amax(dim=-1), tmin_lo[:, None])
    texit = torch.minimum(t_hi.amin(dim=-1), tmax_hi[:, None])
    nonempty = (b_lo <= b_hi).all(dim=-1)[None, :]
    return (tenter <= texit) & nonempty, tenter


def cluster_schedule(raysT: torch.Tensor, clusters: torch.Tensor):
    """(schedmask [NB, 2*SW] i32, counts [NB] i32, params [2] f32).

    Row b holds, sorted ascending, enc = (tkey << 16) | entry id, where
    tkey is the entry distance quantized down to 15 bits (so a sorted
    row is front to back, ties by id), padded with KEY_MAX << 16; then
    the per-member liveness bitmasks in the same order. counts[b] is the
    number of live entries; params = (key scale, t_cap). SW is NSC + 1
    rounded up to 128, as in the reference."""
    live, tenter = block_liveness(raysT, clusters)
    nb, nc = live.shape
    dev = raysT.device
    m = pick_members(nc)
    if nc % m:
        raise ValueError("compute_pack pads NC to a multiple of M")
    nsc = nc // m

    nonempty = (clusters[:, 0:3] <= clusters[:, 3:6]).all(dim=-1)
    glo = torch.where(nonempty[:, None], clusters[:, 0:3], BIG_T).amin(dim=0)
    ghi = torch.where(nonempty[:, None], clusters[:, 3:6], -BIG_T).amax(dim=0)
    ext = torch.clamp_min(ghi - glo, 0.0)
    t_cap = 2.0 * torch.sqrt(_rowsum3(ext * ext)) + 1.0
    # a tensor numerator: `scalar / tensor` would multiply by a rounded
    # reciprocal instead of dividing
    scale = torch.full_like(t_cap, KEY_MAX - 4.0) / t_cap

    live_g = live.reshape(nb, nsc, m)
    sc_live = live_g.any(dim=2)
    sc_t = torch.where(live_g, tenter.reshape(nb, nsc, m), BIG_T).amin(dim=2)
    bits = (live_g.to(torch.int32)
            * (1 << torch.arange(m, dtype=torch.int32, device=dev))).sum(
                dim=2, dtype=torch.int32)
    tk = torch.minimum(torch.clamp_min(torch.where(sc_live, sc_t, BIG_T), 0.0),
                       t_cap) * scale
    tkey = torch.clamp(tk, 0.0, float(KEY_MAX)).to(torch.int32)
    enc = tkey * 65536 + torch.arange(nsc, dtype=torch.int32, device=dev)
    # enc is unique per row, so a sort gives exactly the rank order
    enc_sorted, perm = torch.sort(enc, dim=1)
    bits_sorted = bits.gather(1, perm)
    counts = sc_live.sum(dim=1, dtype=torch.int32)
    sw = (nsc + 1 + 127) // 128 * 128
    schedmask = torch.zeros((nb, 2 * sw), dtype=torch.int32, device=dev)
    schedmask[:, :sw] = KEY_MAX * 65536
    schedmask[:, :nsc] = enc_sorted
    schedmask[:, sw:sw + nsc] = bits_sorted
    return schedmask, counts, torch.stack([scale, t_cap])


# ------------------------------------------------------- plain versions
def _mt_epilogue(res, tmin, tmax, c: int):
    """Hit test on [B, 256, 4c] determinant products -> (t masked with
    BIG_T on a miss, hit, det), each [B, 256, c]."""
    t_num = res[..., 0 * c:1 * c]
    det = res[..., 1 * c:2 * c]
    u_num = res[..., 2 * c:3 * c]
    v_num = res[..., 3 * c:4 * c]
    ud = u_num * det
    vd = v_num * det
    ok = (det.abs() > DET_EPS) & (ud >= 0.0) & (vd >= 0.0) & (ud + vd <= det * det)
    inv_det = 1.0 / torch.where(det.abs() > DET_EPS, det, 1.0)
    t = t_num * inv_det
    ok = ok & (t > tmin) & (t < tmax)
    return torch.where(ok, t, BIG_T), ok, det


def _schedule_steps(raysT, coef, schedmask, counts):
    """Yield (block ids, cluster ids, [B, 256, 4c] products) for every
    scheduled (block, member cluster) pair, chunked so one product stays
    under _PLAIN_CHUNK_BYTES. Each block sees its pairs in the kernels'
    order: entries l = 0..count-1, and inside entry l (supercluster sc)
    the members mi = 0..M-1 whose liveness bit is set, cluster sc*M + mi.
    With M == 1 every entry is tested and the bitmask is not read, as in
    the reference."""
    pin_fp32(raysT.device)
    feats = raysT[:, :NFEAT, :].transpose(1, 2)            # [NB,256,10]
    chunk = max(1, _PLAIN_CHUNK_BYTES // (RAY_BLOCK * coef.shape[2] * 4))
    m = pick_members(coef.shape[0])
    sw = schedmask.shape[1] // 2
    steps = int(counts.max()) if counts.numel() else 0
    for l in range(steps):
        alive = counts > l
        for mi in range(m):
            sel = alive if m == 1 else \
                alive & (((schedmask[:, sw + l] >> mi) & 1) == 1)
            for b in torch.nonzero(sel).squeeze(1).split(chunk):
                jc = (schedmask[b, l] & 0xFFFF).long() * m + mi
                yield b, jc, torch.bmm(feats[b], coef[jc, :NFEAT, :])


def closest_hit_plain(raysT, coef, schedmask, counts, params):
    """Plain PyTorch version of the closest-hit kernel: a dense float32
    product per scheduled (block, cluster) pair and the same epilogue.
    Walks every scheduled entry; the kernel's early break skips only
    clusters that cannot improve any ray's hit, so the result is the
    same. Returns (t [NB, 256] f32, idx [NB, 256] i32)."""
    nb, c = raysT.shape[0], coef.shape[2] // 4
    best_t = torch.full((nb, RAY_BLOCK), BIG_T, device=raysT.device)
    best_i = torch.full((nb, RAY_BLOCK), -1, dtype=torch.int32,
                        device=raysT.device)
    tmin = raysT[:, 10, :, None]
    tmax = raysT[:, 11, :, None]
    for b, jc, res in _schedule_steps(raysT, coef, schedmask, counts):
        t, _, _ = _mt_epilogue(res, tmin[b], tmax[b], c)
        lane = torch.argmin(t, dim=2, keepdim=True)        # lowest lane on ties
        bt = t.gather(2, lane)[..., 0]
        better = bt < best_t[b]
        best_t[b] = torch.where(better, bt, best_t[b])
        gi = (jc[:, None] * c + lane[..., 0]).to(torch.int32)
        best_i[b] = torch.where(better, gi, best_i[b])
    return best_t, best_i


def occlusion_plain(raysT, coef, aux, schedmask, counts, params):
    """Plain PyTorch version of the occlusion kernel. Returns the RGB
    attenuation (ar, ag, ab) and the nearest opaque hit's t (BIG_T where
    none), each [NB, 256] f32."""
    nb, c = raysT.shape[0], coef.shape[2] // 4
    tflags = cluster_tflags(aux)
    atten = torch.ones((3, nb, RAY_BLOCK), device=raysT.device)
    tmin = raysT[:, 10, :, None]
    tmax = raysT[:, 11, :, None]
    t_opaque = torch.full((nb, RAY_BLOCK), BIG_T, device=raysT.device)
    for b, jc, res in _schedule_steps(raysT, coef, schedmask, counts):
        t_hit, hit, det = _mt_epilogue(res, tmin[b], tmax[b], c)
        ab = aux[jc]                                       # [B,8,c]
        opaque = torch.where(ab[:, None, 0, :] > 0.0, BIG_T, t_hit)
        t_opaque[b] = torch.minimum(t_opaque[b], opaque.amin(dim=2))
        # transparent clusters: product of per-hit Fresnel factors
        ndi = det.abs() * ab[:, None, 4, :]
        c1 = torch.clamp(1.0 - ndi, 0.0, 1.0)
        c5 = c1 * c1
        c5 = c5 * c5 * c1
        transp = ab[:, None, 0, :] > 0.0
        prods = []
        for ch in range(3):
            sa = ab[:, None, 1 + ch, :]
            fr = torch.clamp(1.0 - ((1.0 - sa) + sa * c5), 0.0, 1.0)
            factor = torch.where(hit, torch.where(transp, fr, 0.0), 1.0)
            prods.append(torch.prod(factor, dim=2))
        # opaque clusters: any hit blocks the light
        keep = 1.0 - hit.any(dim=2).to(torch.float32)
        tf = tflags[jc][:, None] == 1
        for ch in range(3):
            atten[ch, b] = atten[ch, b] * torch.where(tf, prods[ch], keep)
    return atten[0], atten[1], atten[2], t_opaque


def cluster_tflags(aux: torch.Tensor) -> torch.Tensor:
    """[NC] i32: 1 iff the cluster holds any transparent triangle."""
    return (aux[:, 0, :].amax(dim=1) > 0.0).to(torch.int32)


# ------------------------------------------------------- work counted
def triangle_boxes(scene) -> torch.Tensor:
    """[NC, c, 6] f32: each triangle's box (min, max), padded as the pack
    pads its triangles; padding and degenerate triangles get empty boxes."""
    v0, e1, e2 = scene.v0, scene.e1, scene.e2
    t = v0.shape[0]
    c = pick_cluster(t)
    pad = (-t) % (c * pick_members((t + c - 1) // c))
    z = torch.zeros((pad, 3), dtype=v0.dtype, device=v0.device)
    v0, e1, e2 = (torch.cat([a, z]) for a in (v0, e1, e2))
    v1, v2 = v0 + e1, v0 + e2
    degen = (_rowsum3(e1 * e1) + _rowsum3(e2 * e2)) == 0.0
    lo = torch.where(degen[:, None], BIG_T,
                     torch.minimum(torch.minimum(v0, v1), v2))
    hi = torch.where(degen[:, None], -BIG_T,
                     torch.maximum(torch.maximum(v0, v1), v2))
    return torch.cat([lo, hi], dim=1).reshape(-1, c, 6)


def _entered(rays, boxes, limit):
    """[B, 256, c] bool: each ray meets each triangle's box [B, c, 6]
    inside [t_min, min(t_max, limit)] (slab test; culled rays, t_max <
    t_min, never)."""
    o = rays[:, 0:3, :, None]
    inv = rays[:, 12:15, :, None]
    lo = boxes[:, None, :, 0:3].permute(0, 3, 1, 2)        # [B, 3, 1, c]
    hi = boxes[:, None, :, 3:6].permute(0, 3, 1, 2)
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tn = torch.maximum(torch.minimum(t1, t2).amax(dim=1),
                       rays[:, 10, :, None])
    tf = torch.minimum(torch.maximum(t1, t2).amin(dim=1),
                       torch.minimum(rays[:, 11, :], limit)[..., None])
    return tn <= tf


@torch.no_grad()
def call_work(kind, raysT, boxes, schedmask, counts, limit,
              blocked=None) -> dict:
    """The work one call's rays and the scene need, counted ray by ray
    and triangle by triangle: a closest-hit ray tests every triangle
    whose box it enters before its hit (`limit`); an occlusion ray that
    an opaque triangle blocks (`blocked`) tests that one, another every
    triangle whose box it enters before t_max. Returns the (ray,
    triangle) pairs, the rays traced and the triangles some ray needs."""
    nb, c = raysT.shape[0], boxes.shape[1]
    m = pick_members(boxes.shape[0])
    sw = schedmask.shape[1] // 2
    lim = limit.reshape(nb, RAY_BLOCK)
    if blocked is not None:
        lim = torch.where(blocked, -BIG_T, lim)
    chunk = max(1, _PLAIN_CHUNK_BYTES // (RAY_BLOCK * c * 16))
    pairs = torch.zeros((), dtype=torch.int64, device=raysT.device)
    used = torch.zeros(boxes.shape[:2], dtype=torch.bool,
                       device=raysT.device)
    steps = int(counts.max()) if counts.numel() else 0
    for l in range(steps):
        alive = counts > l
        for mi in range(m):
            sel = alive if m == 1 else \
                alive & (((schedmask[:, sw + l] >> mi) & 1) == 1)
            for b in torch.nonzero(sel).squeeze(1).split(chunk):
                jc = (schedmask[b, l] & 0xFFFF).long() * m + mi
                hit = _entered(raysT[b], boxes[jc], lim[b])
                pairs += hit.sum()
                used[jc] |= hit.any(dim=1)
    rays = raysT[:, 11, :] >= raysT[:, 10, :]
    if blocked is not None:
        pairs += (blocked & rays).sum()
    return {"kind": kind, "rays": int(rays.sum()), "pairs": int(pairs),
            "triangles": int(used.sum())}


# ------------------------------------------------------------ front ends
@torch.no_grad()
def intersect_cluster(scene, ro: Vec3, rd: Vec3, t_min, t_max) -> Hit:
    """Closest hit for SoA rays. Returns (t, tri) with u = v = 0: callers
    refine the winner (intersect.refine_hit_v)."""
    raysT, n = pack_raysT(ro, rd, t_min, t_max)
    sched, counts, params = cluster_schedule(raysT, scene.cluster_aabb)
    t, idx = closest_hit_plain(raysT, scene.isect_coef, sched, counts, params)
    if scene.work is not None:
        scene.work.append(call_work("closest_hit", raysT, scene.tri_box,
                                    sched, counts, t))
    z = torch.zeros((n,), dtype=torch.float32, device=raysT.device)
    return Hit(t=t.reshape(-1)[:n], tri=idx.reshape(-1)[:n], u=z, v=z)


@torch.no_grad()
def occlusion_cluster(scene, ro: Vec3, rd: Vec3, t_min, t_max) -> Vec3:
    """RGB shadow attenuation for SoA rays."""
    raysT, n = pack_raysT(ro, rd, t_min, t_max)
    sched, counts, params = cluster_schedule(raysT, scene.cluster_aabb)
    ar, ag, ab, t_opaque = occlusion_plain(
        raysT, scene.isect_coef, scene.isect_aux, sched, counts, params)
    if scene.work is not None:
        scene.work.append(call_work("occlusion", raysT, scene.tri_box,
                                    sched, counts, raysT[:, 11, :],
                                    blocked=t_opaque < BIG_T))
    cut = lambda a: a.reshape(-1)[:n]
    return Vec3(cut(ar), cut(ag), cut(ab))
