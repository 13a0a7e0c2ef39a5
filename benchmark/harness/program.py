"""The program under test, fovtrace_torch: its scene, camera and
configuration built from the benchmark's arrays."""

from __future__ import annotations

from harness import scenes


def render_config(config: dict, overrides: dict | None = None):
    from fovtrace_torch.config import RenderConfig

    r = dict(config["render"], **(overrides or {}))
    r["bounce_budget_fracs"] = tuple(r["bounce_budget_fracs"])
    return RenderConfig(width=config["width"], height=config["height"],
                        full_outputs=False, **r)


def build_scene(config: dict, mesh: dict, env, device):
    """The port's scene from the benchmark's arrays: Scene.build, its BVH
    leaf order and cluster pack on the host (with_bvh), one upload."""
    from fovtrace_torch.scene.scene import (Materials, ParallelogramLight,
                                            Scene)

    lt = config["light"]
    light = ParallelogramLight.create(lt["corner"], lt["v1"], lt["v2"],
                                      (lt["power"],) * 3)
    mats = Materials.create(**scenes.material_columns(config))
    scene = Scene.build(mesh["vertices"], mesh["triangles"], mesh["mat_ids"],
                        materials=mats, normals=mesh["normals"],
                        uvs=mesh["uvs"], light=light, envmap=env)
    return scene.with_bvh().to(device)


def camera(eye, target, config: dict, device):
    from fovtrace_torch.core.camera import Camera

    c = config["camera"]
    return Camera.create(eye=tuple(float(x) for x in eye),
                         target=tuple(float(x) for x in target),
                         up=tuple(c["up"]), fov_y=c["fov_y"], device=device)
