"""Cluster ray/triangle intersection: the pack, the schedule, and the
closest-hit and occlusion kernels (counterpart of
`fovtrace/kernels/pallas_isect.py`).

Triangles, in BVH leaf order, are cut into clusters of c = 128 with
precomputed AABBs. Moller-Trumbore is written as four determinants
linear in the ray feature f = [o, d, o x d, 1] (Cramer / Plucker form):

    det   = f . [0,   -n,      0,  0     ]
    t*det = f . [n,    0,      0,  -v0.n ]
    u*det = f . [0,  v0 x e2,  e2, 0     ]
    v*det = f . [0,  e1 x v0, -e1, 0     ]

so one cluster is a [10, 4c] coefficient slab (`compute_pack`). Rays are
packed as [NB, 16, 256] feature blocks (`pack_raysT`); per 256-ray block
an interval-arithmetic bundle-vs-AABB test (`block_liveness`) gives the
live clusters, sorted front to back by their entry distance
(`cluster_schedule`). Above MAX_SCHED clusters an entry is a
supercluster of M member clusters with a per-member liveness bitmask.
The kernels walk that schedule and stop once the next entry starts
beyond every ray's best hit (closest hit) or beyond every ray's t_max,
or once every ray is fully occluded (occlusion).

Two routes, as in the reference: packs up to `_COEF_RESIDENT_BYTES`
take the resident kernels (flat schedule, M == 1), larger packs the
streaming kernels (`route`). Both copy each live cluster's triangle
records (`triangle_records`, built once per pack) into a ring of
shared-memory stages; the resident kernels run persistent CTAs that take
the ray blocks from a ticket counter, longest first (`ticket_order`).
Each kernel wrapper launches the CUDA kernel of its route
(`csrc/cluster_isect.cu`) on a CUDA tensor and runs the plain PyTorch
version on a CPU tensor; any other device raises. The wrappers count
their launches and the plain versions their calls, so a run can show
which one it used.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import shutil
from pathlib import Path

import torch

from fovtrace_torch import _build, kernels
from fovtrace_torch.app.profiler import span
from fovtrace_torch.config import pin_fp32
from fovtrace_torch.core import vec
from fovtrace_torch.core.vec import Vec3
from fovtrace_torch.kernels import envmap, material
from fovtrace_torch.kernels.intersect import BIG_T, DET_EPS, Hit

CLUSTER = 128        # minimum triangles per cluster
MAX_CLUSTERS = 4096  # the schedule's id field is 16 bits
MAX_SCHED = 1024     # cap on scheduled entries per ray block
RAY_BLOCK = 256      # rays per schedule bundle (one CUDA block)
NFEAT = 10           # rows of the ray feature that meet the coefficients
KEY_MAX = (1 << 15) - 1

# packs whose bf16x3 form is larger stream (see `route`); the
# reference's threshold, pallas_isect._COEF_RESIDENT_BYTES
_COEF_RESIDENT_BYTES = 4 * 1024 * 1024

# bytes of one [B, 256, 4c] f32 product the plain versions materialize
_PLAIN_CHUNK_BYTES = 64 << 20

_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "cluster_isect.cu"
TMA_HEADER = _CSRC.parent / "tma.cuh"

# the streaming kernels split a ray block with more live schedule
# entries than this over eight CTAs of 32 rays (HEAVY in the CUDA source)
STREAM_HEAVY = 64
# a split forced for tests and measurement (`forced_split`): the kernels'
# (heavy_at, launch the split CTAs) by mode
_SPLIT_MODES = {"all": (-1, True), "none": (1 << 30, False),
                "idle": (1 << 30, True)}
_split = None
# a resident grid and ticket order forced for tests and measurement
# (`forced_grid`): (CTAs, order)
_GRID_ORDERS = ("longest", "ascending")
_grid = None


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
    from fovtrace_torch.scene.scene import MATL_REFRACTION, host_cross, host_norm

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


def triangle_records(coef: torch.Tensor) -> torch.Tensor:
    """[NC, c, 40] f32: the kernels' per-triangle records,
    rec[jc, j, q*10 + k] = coef[jc, k, q*c + j] for the coefficient rows
    k = 0..9 and the columns q (t_num, det, u_num, v_num), so each member
    cluster is one contiguous c x 160-byte slab that a kernel copies into
    shared memory as it is. The aux rows 0-4 that occlusion stages for a
    transparent member are already one contiguous slab, `aux[jc, 0:5]`."""
    nc, c = coef.shape[0], coef.shape[2] // 4
    return (coef[:, :NFEAT, :].reshape(nc, NFEAT, 4, c).permute(0, 3, 2, 1)
            .reshape(nc, c, 4 * NFEAT).contiguous())


def stream_inputs(coef: torch.Tensor, aux: torch.Tensor) -> dict:
    """The Scene fields derived from a pack for the kernels:
    `isect_rec` (`triangle_records`) and `isect_tflags`
    (`cluster_tflags`)."""
    return dict(isect_rec=triangle_records(coef),
                isect_tflags=cluster_tflags(aux))


def pack_raysT(ro: Vec3, rd: Vec3, t_min, t_max):
    """SoA rays -> ([NB, 16, 256] feature blocks, N). Rows: o (3), d (3),
    o x d (3), 1, t_min, t_max, 1/d (3), 0. N is padded to whole blocks
    with filler rays d = (1,0,0), t_max = -1 that never hit. A bound
    given as a number goes up to the device in a blocking copy (span
    fov.sync.ray_bound)."""
    n = ro.x.shape[0]
    dev = ro.x.device

    def f(a):
        up = not (torch.is_tensor(a) and a.device == dev)
        with span("fov.sync.ray_bound") if up else contextlib.nullcontext():
            return torch.as_tensor(a, dtype=torch.float32,
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
    kernels.CALLS["closest_hit_plain"] += 1
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
    attenuation (ar, ag, ab), each [NB, 256] f32."""
    kernels.CALLS["occlusion_plain"] += 1
    nb, c = raysT.shape[0], coef.shape[2] // 4
    tflags = cluster_tflags(aux)
    atten = torch.ones((3, nb, RAY_BLOCK), device=raysT.device)
    tmin = raysT[:, 10, :, None]
    tmax = raysT[:, 11, :, None]
    for b, jc, res in _schedule_steps(raysT, coef, schedmask, counts):
        _, hit, det = _mt_epilogue(res, tmin[b], tmax[b], c)
        ab = aux[jc]                                       # [B,8,c]
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
    return atten[0], atten[1], atten[2]


def cluster_tflags(aux: torch.Tensor) -> torch.Tensor:
    """[NC] i32: 1 iff the cluster holds any transparent triangle."""
    return (aux[:, 0, :].amax(dim=1) > 0.0).to(torch.int32)


# --------------------------------------------------------- CUDA kernels
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _nvcc_command(srcs, out):
    # --fmad=false: no implicit multiply-add contraction, so the epilogue
    # rounds like the plain version; the dot products use explicit fmaf
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
            "-Xcompiler", "-fPIC", "-o", out, *srcs]


def c_signatures() -> dict:
    """{C entry point: (argtypes, restype)} of the kernel library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    out = {"fov_resident_ctas": ([i, i, i], i)}
    # data pointers, then visited and ray_visited (may be NULL), the ints,
    # the stream. The resident kernels take two more pointers (the ticket
    # order and counter) and nb, c, sw, their forced-grid entry points the
    # grid after; the streaming kernels nb, c, sw, m,
    # their forced-split entry points heavy_at and nsplit after
    for name, nptr in (("closest_hit", 7), ("occlusion", 10)):
        for suffix, argtypes in (
                ("", [p] * (nptr + 4) + [i] * 3 + [p]),
                ("_grid", [p] * (nptr + 4) + [i] * 4 + [p]),
                ("_stream", [p] * (nptr + 2) + [i] * 4 + [p]),
                ("_stream_split", [p] * (nptr + 2) + [i] * 6 + [p])):
            out[f"fov_{name}{suffix}"] = (argtypes, i)
    return out


@functools.cache
def load_cuda_library() -> ctypes.CDLL:
    """The compiled kernel library (built at first use)."""
    return _build.load_library("fovtrace_cluster_isect", [_CSRC],
                               _nvcc_command, c_signatures(), [TMA_HEADER])


def _check(raysT, coef, schedmask, counts, params, aux=None, visited=None,
           rec=None, tflags=None, ray_visited=None):
    """Validate what the kernels (and their plain versions) take."""
    dev = raysT.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"cluster intersection runs on cpu or cuda, not {dev}")
    want = [(raysT, torch.float32, "raysT"), (coef, torch.float32, "coef"),
            (schedmask, torch.int32, "schedmask"),
            (counts, torch.int32, "counts"), (params, torch.float32, "params"),
            (aux, torch.float32, "aux"), (visited, torch.int32, "visited"),
            (rec, torch.float32, "rec"), (tflags, torch.int32, "tflags"),
            (ray_visited, torch.int32, "ray_visited")]
    want = [w for w in want if w[0] is not None]
    for t, dt, name in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rays on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    nb, nc = raysT.shape[0], coef.shape[0]
    if raysT.shape[1:] != (16, RAY_BLOCK):
        raise ValueError(f"raysT must be [NB, 16, {RAY_BLOCK}], got "
                         f"{tuple(raysT.shape)}")
    if coef.dim() != 3 or coef.shape[1] != 16 or coef.shape[2] % 4:
        raise ValueError(f"coef must be [NC, 16, 4c], got {tuple(coef.shape)}")
    c = coef.shape[2] // 4
    if aux is not None and tuple(aux.shape) != (nc, 8, c):
        raise ValueError(f"aux must be [{nc}, 8, {c}], got {tuple(aux.shape)}")
    if rec is not None and tuple(rec.shape) != (nc, c, 4 * NFEAT):
        raise ValueError(f"rec must be [{nc}, {c}, {4 * NFEAT}], got "
                         f"{tuple(rec.shape)}")
    if tflags is not None and tuple(tflags.shape) != (nc,):
        raise ValueError(f"tflags must be [{nc}], got {tuple(tflags.shape)}")
    nsc = nc // pick_members(nc)
    if schedmask.dim() != 2 or schedmask.shape[0] != nb or \
            schedmask.shape[1] % 2 or schedmask.shape[1] // 2 <= nsc:
        raise ValueError(f"schedmask must be [{nb}, 2*SW], SW > {nsc}, got "
                         f"{tuple(schedmask.shape)}")
    if tuple(counts.shape) != (nb,) or tuple(params.shape) != (2,):
        raise ValueError("counts must be [NB] and params [2]")
    for name, v in (("visited", visited), ("ray_visited", ray_visited)):
        if v is None:
            continue
        if dev.type == "cpu":
            raise ValueError(f"{name} counts a CUDA kernel's work; the plain "
                             "version walks every entry")
        if tuple(v.shape) != (nb,):
            raise ValueError(f"{name} must be [{nb}]")
    return nb, nc, c


def route(nc: int, c: int) -> str:
    """The CUDA kernels a pack of `nc` clusters of width `c` takes:
    "stream" or "resident". A port-side copy of the reference's rule
    (fovtrace/kernels/pallas_isect.py, `_closest_call_pre`): it streams
    when its bf16x3 pack, [NC, 48, 4c] bf16, exceeds
    `_COEF_RESIDENT_BYTES`, so every scene takes the counterpart of the
    kernel the reference gives it (earth: resident; city: streaming)."""
    if nc * 48 * 4 * c * 2 > _COEF_RESIDENT_BYTES:
        return "stream"
    if pick_members(nc) != 1:
        # the reference asserts the same: resident packs are flat
        raise NotImplementedError(
            f"{nc} clusters schedule as supercluster entries of "
            f"M={pick_members(nc)}; the resident kernels take the flat "
            "(M == 1) schedule only")
    return "resident"


def ticket_order(counts: torch.Tensor) -> torch.Tensor:
    """[NB] int64: the order in which the resident kernels' persistent
    CTAs take the ray blocks, the most live entries first (ties in block
    order), so that no long walk starts last. A stable sort on the
    counts' device, with no host sync."""
    return torch.argsort(counts, descending=True, stable=True)


def resident_ctas(kind: str, nb: int, c: int) -> int:
    """The persistent grid the resident kernel `kind` ("closest_hit" or
    "occlusion") launches for nb ray blocks of cluster width c on the
    current card: as many CTAs as fit at once, at most nb."""
    n = load_cuda_library().fov_resident_ctas(int(kind == "occlusion"), nb, c)
    if n < 0:
        raise RuntimeError(f"{kind}: CUDA error {-n} sizing the grid")
    return n


@contextlib.contextmanager
def forced_grid(ctas: int = 0, order: str = "longest"):
    """For tests and measurement: inside the block the resident kernels
    run `ctas` persistent CTAs (0: as many as fit, as the render path
    does) and take the ray blocks longest first (`ticket_order`, as the
    render path does) or in ascending block order."""
    global _grid
    if order not in _GRID_ORDERS or ctas < 0:
        raise ValueError(f"forced_grid({ctas}, {order!r}): CTAs >= 0, "
                         f"order in {_GRID_ORDERS}")
    saved, _grid = _grid, (ctas, order)
    try:
        yield
    finally:
        _grid = saved


@contextlib.contextmanager
def forced_split(mode: str):
    """For tests and measurement: inside the block the streaming
    kernels split every ray block over eight CTAs ("all"), none ("none",
    launching no CTA for a split), or none while launching the split CTAs
    of every block, which all return at once ("idle"); the render path
    splits the blocks with more than STREAM_HEAVY live entries."""
    global _split
    saved, _split = _split, _SPLIT_MODES[mode]
    try:
        yield
    finally:
        _split = saved


def _tickets(counts):
    """The resident kernels' (ticket order, zeroed ticket counter)."""
    if _grid is not None and _grid[1] == "ascending":
        order = torch.arange(counts.shape[0], device=counts.device)
    else:
        order = ticket_order(counts)
    return order, torch.zeros(1, dtype=torch.int32, device=counts.device)


def _launch(kind, r, raysT, ptrs, visited, ray_visited, shape):
    """Launch kernel `kind` ("closest_hit" or "occlusion") of route `r`
    on the current stream; raise on a CUDA error, count the launch.
    `ptrs` are its data tensors in the C function's order, `shape` its
    (nb, c, sw) on the resident route, (nb, c, sw, m) on the streaming
    one. The counts are zeroed first: the warps (and a split ray block's
    CTAs) add theirs up."""
    name = f"{kind}_stream" if r == "stream" else kind
    entry = name
    ptr = lambda t: None if t is None else t.data_ptr()
    for v in (visited, ray_visited):
        if v is not None:
            v.zero_()
    args = [ptr(t) for t in ptrs] + [ptr(visited), ptr(ray_visited), *shape]
    if r == "stream" and _split is not None:
        heavy_at, split_ctas = _split
        entry = f"{name}_split"
        args += [heavy_at, shape[0] if split_ctas else 0]
    elif r == "resident" and _grid is not None:
        entry = f"{name}_grid"
        args.append(_grid[0])
    err = getattr(load_cuda_library(), f"fov_{entry}")(
        *args, torch.cuda.current_stream(raysT.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kind} ({r}) kernel launch failed: CUDA error "
                           f"{err}")
    kernels.CALLS[name] += 1


def closest_hit(raysT, coef, schedmask, counts, params, visited=None, *,
                rec=None, ray_visited=None):
    """Closest hit per ray: (t [NB, 256] f32, idx [NB, 256] i32, -1 on a
    miss). t is the selection distance; callers refine the winner.

    Replaces `_closest_kernel` (resident route) and
    `_closest_kernel_stream` (streaming route) of
    fovtrace/kernels/pallas_isect.py, by the pack's `route`. Both are
    bound by per-pair arithmetic issue, not by memory (source note in
    csrc/cluster_isect.cu). Both copy each live cluster's triangle
    records `rec` (`triangle_records(coef)`, derived here when not given;
    `coef` itself feeds only the plain version) into a ring of
    shared-memory stages by TMA, give each thread 4 rays and a share of
    the cluster's triangles, merge the rays' (t, id) exactly at the end
    of each entry and let each warp stop on its own bound. The resident
    kernel runs persistent CTAs that take the ray blocks longest first
    through one ring; the streaming kernel runs a CTA per ray block and
    splits a ray block with more than STREAM_HEAVY live entries over
    eight CTAs. Their ids and t are equal on a flat schedule.
    `visited`, an optional [NB] int32 CUDA tensor, receives the member
    clusters each block tested; `ray_visited` rays x member clusters its
    warps computed."""
    nb, nc, c = _check(raysT, coef, schedmask, counts, params,
                       visited=visited, rec=rec, ray_visited=ray_visited)
    if raysT.device.type == "cpu":
        return closest_hit_plain(raysT, coef, schedmask, counts, params)
    t = torch.empty((nb, RAY_BLOCK), dtype=torch.float32, device=raysT.device)
    idx = torch.empty((nb, RAY_BLOCK), dtype=torch.int32, device=raysT.device)
    r = route(nc, c)
    if rec is None:
        rec = triangle_records(coef)
    sw = schedmask.shape[1] // 2
    if nb and r == "stream":
        _launch("closest_hit", r, raysT,
                (raysT, rec, schedmask, counts, params, t, idx), visited,
                ray_visited, (nb, c, sw, pick_members(nc)))
    elif nb:
        _launch("closest_hit", r, raysT,
                (raysT, rec, schedmask, counts, *_tickets(counts), params, t,
                 idx), visited, ray_visited, (nb, c, sw))
    return t, idx


def occlusion(raysT, coef, aux, schedmask, counts, params, visited=None, *,
              rec=None, tflags=None, ray_visited=None):
    """RGB shadow attenuation per ray: (ar, ag, ab), each [NB, 256] f32.

    Replaces `_occlusion_kernel` and `_occlusion_kernel_stream`
    (fovtrace/kernels/pallas_isect.py). Bound and built like
    `closest_hit`; `tflags` is `cluster_tflags(aux)` (derived here when
    not given). Its early exits (every ray fully occluded, or the
    schedule past t_max) end most warps after a few clusters. The
    kernels multiply a transparent member's Fresnel factors per lane and
    then across the lanes of a ray, in lane order: the product may round
    differently from the plain version's (by at most a few ulp; equal
    when a ray meets at most one factor after the first)."""
    nb, nc, c = _check(raysT, coef, schedmask, counts, params, aux, visited,
                       rec=rec, tflags=tflags, ray_visited=ray_visited)
    if raysT.device.type == "cpu":
        return occlusion_plain(raysT, coef, aux, schedmask, counts, params)
    out = torch.empty((3, nb, RAY_BLOCK), dtype=torch.float32,
                      device=raysT.device)
    r = route(nc, c)
    if tflags is None:
        tflags = cluster_tflags(aux)
    if rec is None:
        rec = triangle_records(coef)
    sw = schedmask.shape[1] // 2
    outs = (out[0], out[1], out[2])
    if nb and r == "stream":
        _launch("occlusion", r, raysT,
                (raysT, rec, aux, tflags, schedmask, counts, params, *outs),
                visited, ray_visited, (nb, c, sw, pick_members(nc)))
    elif nb:
        _launch("occlusion", r, raysT,
                (raysT, rec, aux, tflags, schedmask, counts,
                 *_tickets(counts), params, *outs), visited, ray_visited,
                (nb, c, sw))
    return outs


COUNTED = ("closest_hit", "occlusion", "closest_hit_stream",
           "occlusion_stream", "closest_hit_plain", "occlusion_plain",
           "intersect_brute", "occlusion_brute", "intersect_bvh",
           "occlusion_bvh", *material.COUNTED, *envmap.COUNTED)


def reset_counters() -> None:
    """Zero the kernel launch counts and the plain/brute call counts."""
    kernels.CALLS.clear()


def counters() -> dict:
    """Kernel launches (the material and envmap kernels' too) and
    plain-version / brute-oracle / bvh-traversal calls so far."""
    return {k: kernels.CALLS[k] for k in COUNTED}


# ------------------------------------------------------------ front ends
@torch.no_grad()
def intersect_cluster(scene, ro: Vec3, rd: Vec3, t_min, t_max) -> Hit:
    """Closest hit for SoA rays. Returns (t, tri) from the kernel with
    u = v = 0: callers refine the winner (intersect.refine_hit_v)."""
    raysT, n = pack_raysT(ro, rd, t_min, t_max)
    sched, counts, params = cluster_schedule(raysT, scene.cluster_aabb)
    t, idx = closest_hit(raysT, scene.isect_coef, sched, counts, params,
                         rec=scene.isect_rec)
    z = torch.zeros((n,), dtype=torch.float32, device=raysT.device)
    return Hit(t=t.reshape(-1)[:n], tri=idx.reshape(-1)[:n], u=z, v=z)


@torch.no_grad()
def occlusion_cluster(scene, ro: Vec3, rd: Vec3, t_min, t_max) -> Vec3:
    """RGB shadow attenuation for SoA rays."""
    raysT, n = pack_raysT(ro, rd, t_min, t_max)
    sched, counts, params = cluster_schedule(raysT, scene.cluster_aabb)
    ar, ag, ab = occlusion(raysT, scene.isect_coef, scene.isect_aux, sched,
                           counts, params, rec=scene.isect_rec,
                           tflags=scene.isect_tflags)
    cut = lambda a: a.reshape(-1)[:n]
    return Vec3(cut(ar), cut(ag), cut(ab))
