"""Faults planted under the timed path, for the benchmark's own tests: each
must turn `correct` false (benchmark/tests/test_faults.py).

  state_unchanged  a frame returns the state it was given; a train step
                   leaves the parameters as they were
  half_batch       half of the work left out and the rest counted twice:
                   the lower half of the frame's sample mask dropped; the
                   train image's lower rows replaced by its upper rows
  no_exchange      the port's collectives skip the exchange between ranks
  altered_answer   the answer changed where it is produced: 0.05 added to
                   the red channel of every 20th image row; the train
                   step's loss scaled by 1.01
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_batch", "no_exchange", "altered_answer")


class _NoExchange:
    """torch.distributed as the port's collectives see it, with the
    exchange left out."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    def all_reduce(self, *a, **k):
        return None

    def broadcast(self, *a, **k):
        return None


@contextlib.contextmanager
def applied(name: str | None):
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise SystemExit(f"unknown fault {name!r}")
    from fovtrace_torch.dist import collectives, sharding, train
    from fovtrace_torch.render import pipeline

    saved = []

    def patch(mod, attr, new):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    if name == "state_unchanged":
        def frame(real):
            def f(scene, cam, gaze, state, *a, **k):
                out, _ = real(scene, cam, gaze, state, *a, **k)
                return out, state
            return f
        patch(pipeline, "render_frame_staged",
              frame(pipeline.render_frame_staged))
        patch(sharding, "render_sharded", frame(sharding.render_sharded))

        def make(*a, **k):
            loss_and_grad = train.make_loss_and_grad(*a, **k)

            def step(params, optimizer, target_rows, frame_no):
                loss, grads = loss_and_grad(params, target_rows, frame_no)
                for p, g in zip(params.tensors(), grads.tensors()):
                    p.grad = g
                return loss
            return step
        patch(train, "make_train_step", make)
    elif name == "half_batch":
        real_mask = pipeline.sample_mask

        def mask(sal, gaze_px, frame_no, config, y0=0):
            m = real_mask(sal, gaze_px, frame_no, config, y0)
            rows = torch.arange(m.shape[0], device=m.device) + y0
            return m & (rows < config.height // 2)[:, None]
        patch(pipeline, "sample_mask", mask)
        real_dense = train.render_rows_dense

        def dense(scene, camera, params, y0, block_h, config, frame_no):
            img = real_dense(scene, camera, params, y0, block_h, config,
                             frame_no)
            half = block_h // 2
            return torch.cat([img[:half], img[:block_h - half]])
        patch(train, "render_rows_dense", dense)
    elif name == "no_exchange":
        patch(collectives, "dist", _NoExchange(collectives.dist))
    else:
        real_frame = pipeline.render_frame_staged

        def frame(*a, **k):
            out, new = real_frame(*a, **k)
            r = out["image_rgb"]
            x = r.x.clone()
            x[::20] += 0.05
            out["image_rgb"] = type(r)(x, r.y, r.z)
            return out, new
        patch(pipeline, "render_frame_staged", frame)
        real_sharded = sharding.render_sharded

        def sharded(*a, **k):
            out, new = real_sharded(*a, **k)
            r = out["image_rgb"]
            x = r.x.clone()
            x[::20] += 0.05
            out["image_rgb"] = type(r)(x, r.y, r.z)
            return out, new
        patch(sharding, "render_sharded", sharded)
        real_make = train.make_train_step

        def make(*a, **k):
            step = real_make(*a, **k)
            return lambda *s: step(*s) * 1.01
        patch(train, "make_train_step", make)
    try:
        yield
    finally:
        for mod, attr, old in reversed(saved):
            setattr(mod, attr, old)
