"""The reference's train-step gradients where a plain formula goes wrong:
the lat-long envmap coordinates at the poles (the forward is the plain
formula's bit for bit, the gradient too off the poles, and at y = +-1,
where acos' slope is infinite, it is v's own, 0.5;
reference/shade.envmap_texel_coords), and the material table's adjoint,
summed in float64 (reference/intersect.RowGather)."""

import math

import numpy as np
import pytest
import torch

from reference import shade
from reference.vec import Vec3

H, W = 64, 128


def _formula(dirs, h, w):
    """The coordinates as the plain formula writes them."""
    theta = torch.atan2(dirs.x, dirs.z)
    phi = math.pi * 0.5 - torch.acos(torch.clamp(dirs.y, -1.0, 1.0))
    u = (theta + math.pi) * (0.5 / math.pi)
    v = 0.5 * (1.0 + torch.sin(phi))
    return u * (w - 1), (1.0 - v) * (h - 1)


POLES = [(0.0, 1.0, 0.0), (0.0, -1.0, 0.0), (-4.27e-6, 1.0, 4.67e-5),
         (3e-7, -1.0, -2e-7)]


def _dirs(n=100_000, seed=1554):
    g = torch.Generator().manual_seed(seed)
    d = torch.randn(n, 3, generator=g, dtype=torch.float64)
    d = (d / d.norm(dim=1, keepdim=True)).float()
    d = torch.cat([d, torch.tensor(POLES, dtype=torch.float32)])
    return d


def _bits(t):
    return t.contiguous().view(torch.int32)


def _coords(fn, d, cot):
    """(fx, fy, d(sum cot . (fx, fy)) / d dirs) of fn."""
    leaf = d.clone().requires_grad_(True)
    fx, fy = fn(Vec3(leaf[:, 0], leaf[:, 1], leaf[:, 2]), H, W)
    (fx * cot[0] + fy * cot[1]).sum().backward()
    return fx.detach(), fy.detach(), leaf.grad


@pytest.fixture(autouse=True)
def _warm_acos():
    # the first large acos call of a process can give other bits than
    # the later ones on some CPU builds: warm it before comparing bits
    for _ in range(2):
        torch.acos(torch.linspace(-1.0, 1.0, 200_003))


def test_forward_equals_the_formula_bit_for_bit():
    d = _dirs()
    with torch.no_grad():
        got = shade.envmap_texel_coords(Vec3(d[:, 0], d[:, 1], d[:, 2]), H, W)
        want = _formula(Vec3(d[:, 0], d[:, 1], d[:, 2]), H, W)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


def test_gradient_equals_the_formula_off_the_poles():
    d = _dirs()
    g = torch.Generator().manual_seed(7)
    cot = torch.randn(2, d.shape[0], generator=g)
    *got, g_got = _coords(shade.envmap_texel_coords, d, cot)
    *want, g_want = _coords(_formula, d, cot)
    off = d[:, 1].abs() < 1.0
    assert int((~off).sum()) == len(POLES)
    assert torch.equal(_bits(g_got[off]), _bits(g_want[off]))
    assert torch.isfinite(g_got).all()
    assert not torch.isfinite(g_want[~off]).all()


@pytest.mark.parametrize("h,w", [(H, W), (8, 16), (1024, 2048)])
def test_gradient_at_the_poles_is_v_s_own(h, w):
    d = torch.tensor(POLES, dtype=torch.float32, requires_grad=True)
    fx, fy = shade.envmap_texel_coords(Vec3(d[:, 0], d[:, 1], d[:, 2]), h, w)
    (gy,) = torch.autograd.grad(fy.sum(), d)
    assert torch.equal(gy[:, 1], torch.full((len(POLES),), -0.5 * (h - 1)))
    assert torch.isfinite(gy).all()
    (gx,) = torch.autograd.grad(fx.sum(), d)
    assert torch.equal(gx[:, 1], torch.zeros(len(POLES)))
    assert torch.isfinite(gx).all()


def _mirror_plane(device):
    """A reflection-kind ground plane (normals exactly +y) under a light,
    with an envmap whose rows all differ, so that the miss lookup at the
    zenith has a gradient in fy."""
    from harness import refside
    from reference.scene import Materials, ParallelogramLight, Scene

    v = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]],
                 np.float32)
    tri = np.array([[0, 2, 1], [0, 3, 2]], np.int64)
    mats = Materials.create([1], [[0.8, 0.8, 0.8]])
    env = np.linspace(0.1, 2.0, 8 * 16 * 3, dtype=np.float32).reshape(
        8, 16, 3)
    light = ParallelogramLight.create((-0.5, 3.0, -0.5), (1.0, 0.0, 0.0),
                                      (0.0, 0.0, 1.0), (40.0,) * 3)
    scene = Scene.build(v, tri, np.zeros(2, np.int32), materials=mats,
                        normals=np.tile([[0, 1, 0]], (4, 1)).astype(
                            np.float32), light=light, envmap=env)
    cfg = {"width": 1, "height": 1, "render": {
        "max_depth": 2, "diffuse_max_depth": 1, "ray_budget_frac": 1.0,
        "bounce_budget_fracs": [1.0], "reconstruction": "none"}}
    return scene.with_clusters().to(device), refside.render_config(cfg)


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_mirror_ray_to_the_zenith_has_finite_gradients(device, request):
    if device == "cuda":
        request.getfixturevalue("card")
    scene, rc = _mirror_plane(device)
    ro = torch.tensor([[0.3], [2.0], [0.2]], device=device,
                      requires_grad=True)
    rd = torch.tensor([[0.0], [-1.0], [0.0]], device=device,
                      requires_grad=True)
    seeds = torch.tensor([12345], dtype=torch.int64, device=device)
    rad, _ = shade.shade_v(scene, Vec3(ro[0], ro[1], ro[2]),
                           Vec3(rd[0], rd[1], rd[2]), seeds, rc)
    total = rad.x + 2.0 * rad.y + 3.0 * rad.z
    assert torch.isfinite(total).all() and float(total.detach().sum()) > 0.0
    g_ro, g_rd = torch.autograd.grad(total.sum(), (ro, rd))
    assert torch.isfinite(g_ro).all() and torch.isfinite(g_rd).all()
    assert float(g_rd.abs().sum()) > 0.0


def test_row_gather_sums_its_adjoint_in_float64():
    """The material table's adjoint (reference/intersect.RowGather) is
    the float64 sum of the cotangents rounded once, however many rays
    share a row; its forward is index_select's."""
    from reference.intersect import RowGather

    n = 3_000_000
    g = torch.Generator().manual_seed(11)
    ids = torch.randint(0, 2, (n,), generator=g)
    ids[: n // 2] = 0
    cot = torch.rand(n, 4, generator=g) * 1e-3
    table = torch.rand(3, 4, generator=g, requires_grad=True)
    out = RowGather.apply(table, ids)
    assert torch.equal(out, table.detach().index_select(0, ids))
    (grad,) = torch.autograd.grad(out, table, cot)
    want = torch.zeros(3, 4, dtype=torch.float64).index_add_(
        0, ids, cot.double()).float()
    assert torch.equal(grad, want)


def test_row_gather_gradcheck():
    from reference.intersect import RowGather

    table = torch.rand(4, 5, dtype=torch.float64, requires_grad=True)
    ids = torch.tensor([0, 3, 3, 1, 0, 2, 3])
    assert torch.autograd.gradcheck(lambda t: RowGather.apply(t, ids),
                                    (table,))
