"""The reference's scene, camera and configuration, from the same arrays
the program is handed (reference/, the plain route)."""

from __future__ import annotations

from harness import scenes


def render_config(config: dict, overrides: dict | None = None):
    from reference.config import RenderConfig

    r = dict(config["render"], **(overrides or {}))
    r["bounce_budget_fracs"] = tuple(r["bounce_budget_fracs"])
    return RenderConfig(width=config["width"], height=config["height"], **r)


def build_scene(config: dict, mesh: dict, env, device):
    from reference.scene import Materials, ParallelogramLight, Scene

    lt = config["light"]
    light = ParallelogramLight.create(lt["corner"], lt["v1"], lt["v2"],
                                      (lt["power"],) * 3)
    mats = Materials.create(**scenes.material_columns(config))
    scene = Scene.build(mesh["vertices"], mesh["triangles"], mesh["mat_ids"],
                        materials=mats, normals=mesh["normals"],
                        uvs=mesh["uvs"], light=light, envmap=env)
    return scene.with_clusters().to(device)


def camera(eye, target, config: dict, device):
    from reference.camera import Camera

    c = config["camera"]
    return Camera.create(eye=tuple(float(x) for x in eye),
                         target=tuple(float(x) for x in target),
                         up=tuple(c["up"]), fov_y=c["fov_y"], device=device)
