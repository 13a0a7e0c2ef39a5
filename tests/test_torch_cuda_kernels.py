"""The CUDA cluster kernels against their plain PyTorch versions, on the
card (earth scene, seeded rays). Marked `cuda`; skipped without a GPU.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from fovtrace_torch import Camera
from fovtrace_torch.core.vec import Vec3
from fovtrace_torch.kernels import cluster_isect as ci
from fovtrace_torch.kernels import intersect as isect
from fovtrace_torch.render import gbuffer
from fovtrace_torch.scene import procedural

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def earth(dev):
    return procedural.earth_scene(dev)


def _ray_sets(scene, dev):
    r = np.random.default_rng(7)
    n = 4096
    ctr = ((scene.bbox_min + scene.bbox_max) / 2).cpu().numpy()
    ext = float(torch.linalg.vector_norm(scene.bbox_max - scene.bbox_min))
    ro = ctr + r.normal(size=(n, 3)).astype(np.float32) * ext
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    v = lambda a: Vec3(*[torch.tensor(a[:, k], device=dev) for k in range(3)])
    cam = Camera.create(eye=(3.0, 2.5, 4.0), target=(0.0, 0.8, 0.0),
                        device=dev)
    pro, prd = cam.primary_rays_v(128, 96)
    swz = lambda a: gbuffer.swizzle_to_tiles(a.reshape(-1), 96, 128)
    return {"random": (v(ro), v(rd), isect.BIG_T),
            "primary": (pro.map(swz), prd.map(swz), isect.BIG_T),
            "ragged": (v(ro[:300]), v(rd[:300]), 3.0)}


@pytest.mark.parametrize("rays", ["random", "primary", "ragged"])
def test_closest_hit_kernel_matches_plain(earth, dev, rays):
    ro, rd, tmax = _ray_sets(earth, dev)[rays]
    raysT, n = ci.pack_raysT(ro, rd, 1e-3, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
    ci.reset_counters()
    tk, ik = ci.closest_hit(raysT, earth.isect_coef, sched, counts, params)
    torch.cuda.synchronize()
    assert ci.counters()["closest_hit"] == 1
    tp, ip = ci.closest_hit_plain(raysT, earth.isect_coef, sched, counts,
                                  params)
    hit = ip >= 0
    assert torch.equal(ik >= 0, hit), "hit/miss flips"
    assert int((ik == ip)[hit].sum()) >= 0.995 * int(hit.sum())
    torch.testing.assert_close(tk[hit], tp[hit], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rays", ["random", "primary", "ragged"])
def test_occlusion_kernel_matches_plain(earth, dev, rays):
    ro, rd, tmax = _ray_sets(earth, dev)[rays]
    raysT, n = ci.pack_raysT(ro, rd, 1e-3, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
    args = (raysT, earth.isect_coef, earth.isect_aux, sched, counts, params)
    ak = torch.stack(ci.occlusion(*args))
    torch.cuda.synchronize()
    ap = torch.stack(ci.occlusion_plain(*args))
    torch.testing.assert_close(ak, ap, rtol=1e-4, atol=1e-4)


def test_kernel_wrappers_refuse_mixed_devices(earth, dev):
    ro, rd, tmax = _ray_sets(earth, dev)["random"]
    raysT, _ = ci.pack_raysT(ro, rd, 1e-3, tmax)
    sched, counts, params = ci.cluster_schedule(raysT, earth.cluster_aabb)
    with pytest.raises(ValueError, match="coef"):
        ci.closest_hit(raysT, earth.isect_coef.cpu(), sched, counts, params)
