"""Intersection, sampling and reconstruction kernels."""

import collections

import torch

# launches of each CUDA kernel and calls of each plain version and brute
# oracle, counted where they run (see cluster_isect.counters), and the
# camera inverse's host round trips ("inv4_host", core/camera.inv4)
CALLS: collections.Counter = collections.Counter()


def launch(lib, name: str, tensors, *args, count: str = "") -> None:
    """Call `lib`'s fov_`name` with the tensors' data pointers, `args` and
    the current stream, raise on a CUDA error, and count the launch in
    CALLS[count or name] (an entry point that forces a variant of a
    kernel counts under the kernel's name). The caller keeps the tensors
    referenced until it returns them or the stream is done with them
    (outputs, and scratch that the caching allocator hands out again only
    on the same stream)."""
    err = getattr(lib, f"fov_{name}")(
        *[t.data_ptr() for t in tensors], *args,
        torch.cuda.current_stream(tensors[0].device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    CALLS[count or name] += 1
