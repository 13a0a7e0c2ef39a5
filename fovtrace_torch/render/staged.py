"""Per-stage timed frames, the CLI's `--profile-stages` (counterpart of
`fovtrace/render/staged.py`, whose name it keeps).

The frame is `pipeline.render_frame_staged`, the one function behind
`pipeline.render_frame` too: the same `pipeline.stage_*` calls on the
same tensors, so its outputs and new state equal render_frame's bit for
bit. Each stage runs inside `timer.stage`, which waits for the stage's
result on its device, so the stage times add up to more than an
unsynchronised frame takes. Columns are the reference's report names:
GB, Sampling, Optimize, Shading, and the reconstruction's JFA, SI, PPI,
AT (those `config.reconstruction` runs).
"""

from fovtrace_torch.render.pipeline import render_frame_staged

__all__ = ["render_frame_staged"]
