"""Render configuration: a frozen dataclass of the frame's parameters."""

from __future__ import annotations

import dataclasses

import torch

SAMPLING_MODES = ("masked", "weier", "author", "full")
RECONSTRUCTIONS = ("pullpush", "atrous", "none")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters, with the port's defaults."""

    width: int = 1024
    height: int = 1024

    # --- foveation ---
    aperture: float = 0.07
    p_min: float = 0.05             # peripheral floor of the Weier falloff
    sampling_mode: str = "masked"   # one of SAMPLING_MODES
    saliency_block: int = 4
    extra_sample_rate: int = 8

    # --- path tracing ---
    diffuse_max_depth: int = 1
    max_depth: int = 4
    importance_cutoff: float = 0.01
    scene_epsilon: float = 1e-3
    envmap_scale: float = 2.0

    # --- ray budgets (static compaction sizes; overflow is truncated and
    #     counted in `rays_dropped`) ---
    ray_budget_frac: float = 0.35
    bounce_budget_fracs: tuple = (0.25, 0.06, 0.02)
    # the row-sharded frame gives each tile this many times its equal
    # share of the budget (the tile holding the fovea needs more than 1/N)
    sharded_budget_factor: float = 2.0

    # --- thin-lens depth of field ---
    dof: bool = False
    lens_radius: float = 0.05

    # --- temporal ---
    temporal: bool = True
    cache_epsilon: float = 1e-3

    # --- reconstruction ---
    reconstruction: str = "pullpush"  # one of RECONSTRUCTIONS
    atrous_iterations: int = 1
    atrous_c_phi: float = 1.0
    atrous_n_phi: float = 0.5
    atrous_p_phi: float = 0.5

    exposure_bias: float = 2.0

    def __post_init__(self):
        if self.sampling_mode not in SAMPLING_MODES:
            raise ValueError(
                f"sampling_mode {self.sampling_mode!r} is not in "
                f"the reference; choose one of {SAMPLING_MODES}")
        if self.reconstruction not in RECONSTRUCTIONS:
            raise ValueError(
                f"reconstruction {self.reconstruction!r} is not in "
                f"the reference; choose one of {RECONSTRUCTIONS}")

    @property
    def ray_budget(self) -> int:
        """Static number of compacted shading rays, padded to a multiple of 1024."""
        n = int(self.width * self.height * self.ray_budget_frac)
        return max(1024, (n + 1023) // 1024 * 1024)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def pin_fp32(device) -> None:
    """Keep float32 matrix products in full float32 on CUDA.

    Sets `torch.backends.cuda.matmul.allow_tf32 = False` and
    `torch.backends.cudnn.allow_tf32 = False` (process-wide): TF32 keeps
    about three decimal digits, which the parity tolerances against the
    reference do not absorb. A no-op for CPU devices."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
