"""fovtrace_torch — the PyTorch/CUDA port of fovtrace.

The forward foveated frame (G-buffer, saliency mask, compaction,
wavefront shading, temporal accumulation, pull-push + A-Trous
reconstruction) in PyTorch, with hand-written CUDA kernels for the two
ray-cluster intersection kernels on the path. The JAX package `fovtrace`
is the reference; module and function names follow it so each port
function has an obvious counterpart.

Every function takes its tensors on an explicit device; nothing here
picks a default device or imports jax.
"""

__version__ = "0.1.0"

from fovtrace_torch.config import RenderConfig
from fovtrace_torch.core.camera import Camera
from fovtrace_torch.scene.scene import Materials, ParallelogramLight, Scene

__all__ = [
    "RenderConfig",
    "Camera",
    "Scene",
    "Materials",
    "ParallelogramLight",
]
