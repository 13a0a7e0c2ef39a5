"""The benchmark's frozen copies equal the port's code today: the mesh
generators, the budget rule and the bound arithmetic."""

import json

import numpy as np
import pytest

from harness import arith, scenes, spec


def _port_meshes(name):
    from fovtrace_torch.scene import procedural
    from fovtrace_torch.scene.scene import merge_meshes

    if name == "city":
        parts = procedural.city_meshes()
    else:
        parts = [procedural._mesh(procedural.plane(8.0, 0.0), 0),
                 procedural._mesh(procedural.uv_sphere(0.8, (0.0, 1.0, 0.0)),
                                  2),
                 procedural._mesh(procedural.box((0.8, 0.8, 0.8),
                                                 (-2.0, 0.4, 1.2)), 3)]
    return merge_meshes(parts)


@pytest.mark.parametrize("cfg,scene", [("earth-uhd", "earth"),
                                       ("city-uhd", "city")])
def test_meshes_equal_the_port_generators(cfg, scene):
    config = json.loads((spec.BENCH / "configs" / f"{cfg}.json").read_text())
    ours = scenes.mesh_arrays(config)
    v, t, m, n, uv = _port_meshes(scene)
    for a, b in zip((ours["vertices"], ours["triangles"], ours["mat_ids"],
                     ours["normals"], ours["uvs"]), (v, t, m, n, uv)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert config["triangles_before_padding"] == len(t)


def test_materials_light_envmap_equal_the_port_defaults():
    from fovtrace_torch.scene import procedural
    from fovtrace_torch.scene.scene import Materials, ParallelogramLight

    config = json.loads((spec.BENCH / "configs" / "city-uhd.json")
                        .read_text())
    ours = Materials.create(**scenes.material_columns(config))
    port = procedural._default_materials()
    for f in port.__dataclass_fields__:
        assert np.array_equal(getattr(ours, f).numpy(),
                              getattr(port, f).numpy()), f
    lt = config["light"]
    a = ParallelogramLight.create(lt["corner"], lt["v1"], lt["v2"],
                                  (lt["power"],) * 3)
    b = ParallelogramLight.default(810.0)
    for f in b.__dataclass_fields__:
        assert np.array_equal(getattr(a, f).numpy(), getattr(b, f).numpy())
    assert np.array_equal(scenes.envmap_array(config),
                          procedural.checker_envmap())


def test_budget_rule_equals_the_bench():
    from fovtrace_torch import bench

    n = 3840 * 2176
    for rc in (0, 1, 1000, n // 8, n // 2, n // 2 + 1, int(n * 0.77), n):
        for dropped in (0, 3):
            assert arith.budget_frac(rc, dropped, n) == \
                bench.budget_frac(rc, dropped, n)


def test_bounds_equal_chip_smoke():
    import chip_smoke

    assert arith.PEAK_F32 == chip_smoke.PEAK_F32
    assert arith.PEAK_BYTES == chip_smoke.PEAK_BYTES
    assert arith.OPS_PER_PAIR == chip_smoke.OPS_PER_PAIR
    for n in (4096, 1044480, 8355840):
        assert arith.material_adjoint_s(n, 4, 4) * 1e3 == pytest.approx(
            chip_smoke.material_bound(n, 4, 4), rel=1e-12)
        assert arith.envmap_adjoint_s(n, 64, 128) * 1e3 == pytest.approx(
            chip_smoke.envmap_bound(n, 64, 128, "adjoint"), rel=1e-12)


def test_bounce_fronts_follow_shade_v():
    fr = arith.bounce_fronts(3840 * 2176, 2, (0.25, 0.06, 0.02))
    assert fr == [8355840, 2088960]
