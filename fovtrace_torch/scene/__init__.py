"""Scene representation, BVH build, the procedural scenes, and scenes
from files (OBJ / MTL, images, assets)."""
from fovtrace_torch.scene.scene import (MATL_DIFFUSE, MATL_REFLECTION,
                                        MATL_REFRACTION, Materials,
                                        ParallelogramLight, Scene)
from fovtrace_torch.scene import assets, image_io, obj, procedural

__all__ = [
    "Scene",
    "Materials",
    "ParallelogramLight",
    "MATL_DIFFUSE",
    "MATL_REFLECTION",
    "MATL_REFRACTION",
    "procedural",
    "obj",
    "image_io",
    "assets",
]
