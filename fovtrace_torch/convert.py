"""Scene, camera and frame state from numpy arrays.

The builders take a flat dict of numpy arrays whose keys are the field
paths of the reference's dataclasses ("v0", "materials.kind",
"light.corner", "prev_camera.eye", ...), as `to_numpy` produces from
any nested dataclass of arrays — the reference package's pytrees
included — so state made elsewhere crosses into the port as plain
numpy, and the port's runtime never sees another framework's objects.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from fovtrace_torch.core.camera import Camera
from fovtrace_torch.render.pipeline import FrameState
from fovtrace_torch.scene.scene import Materials, ParallelogramLight, Scene


def to_numpy(obj, prefix: str = "") -> Dict[str, Any]:
    """Flatten a (nested) dataclass into {dotted field path: value}:
    arrays and tensors become numpy arrays, other values (ints, strings,
    None) pass through."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(v):
            out.update(to_numpy(v, key + "."))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        elif v is None or isinstance(v, (int, float, str)):
            out[key] = v
        else:
            out[key] = np.asarray(v)
    return out


def _sub(d: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    n = len(prefix)
    return {k[n:]: v for k, v in d.items() if k.startswith(prefix)}


def _build(cls, d: Dict[str, Any], device, nested=None):
    kw = {}
    for f in dataclasses.fields(cls):
        if nested and f.name in nested:
            kw[f.name] = nested[f.name]
            continue
        v = d.get(f.name)
        if isinstance(v, np.ndarray):
            v = torch.tensor(v).to(device)
        elif isinstance(v, np.generic):
            v = v.item()
        kw[f.name] = v
    return cls(**kw)


def scene_from_numpy(d: Dict[str, Any], device) -> Scene:
    """A Scene (BVH arrays, intersection pack and attribute rows
    included) from flat numpy arrays. The port's own fields derived from
    the pack (`isect_rec`, `isect_tflags`) are derived here when the
    arrays lack them, as the reference's scenes do."""
    from fovtrace_torch.kernels import cluster_isect

    materials = _build(Materials, _sub(d, "materials."), device)
    light = _build(ParallelogramLight, _sub(d, "light."), device)
    scene = _build(Scene, d, device,
                   nested={"materials": materials, "light": light})
    scene = scene.replace(bvh_max_stack=int(d.get("bvh_max_stack") or 0))
    if scene.isect_coef is not None and scene.isect_rec is None:
        scene = scene.replace(**cluster_isect.stream_inputs(
            scene.isect_coef, scene.isect_aux))
    return scene


def camera_from_numpy(d: Dict[str, Any], device) -> Camera:
    cam = _build(Camera, d, device)
    return cam.replace(mode=str(d.get("mode") or cam.mode))


def frame_state_from_numpy(d: Dict[str, Any], device) -> FrameState:
    cam = camera_from_numpy(_sub(d, "prev_camera."), device)
    state = _build(FrameState, d, device, nested={"prev_camera": cam})
    return dataclasses.replace(state, frame=state.frame.to(torch.int64))
