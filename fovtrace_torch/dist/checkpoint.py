"""Checkpoint and resume of the optimisation loop (counterpart of
`fovtrace/dist/checkpoint.py`).

One file per step, `ckpt_%08d.pt`, written atomically (a temporary file
in the same directory, fsync, os.replace), the newest `keep` kept. A
state is any nesting of dicts, lists and tuples of tensors and numbers
(parameters as a dict, `optimizer.state_dict()`), written by `torch.save`
and read back with `torch.load(weights_only=True)`.
"""

from __future__ import annotations

import dataclasses
import os
import re
import tempfile
from typing import Any, List, Optional, Tuple

import torch

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.pt")


def _plain(state: Any) -> Any:
    """Dataclasses as dicts (weights_only loading takes no classes),
    tensors detached on the CPU."""
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return {f.name: _plain(getattr(state, f.name))
                for f in dataclasses.fields(state)}
    if isinstance(state, dict):
        return {k: _plain(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_plain(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    return state


def _like(target: Any, loaded: Any) -> Any:
    """`loaded` in the structure of `target`: dataclasses rebuilt, each
    tensor on its target's device and in its dtype."""
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return type(target)(**{f.name: _like(getattr(target, f.name),
                                             loaded[f.name])
                               for f in dataclasses.fields(target)})
    if isinstance(target, dict):
        return {k: _like(target[k], loaded[k]) if k in target else loaded[k]
                for k in loaded}
    if isinstance(target, (list, tuple)):
        return type(target)(_like(t, v) for t, v in zip(target, loaded))
    if isinstance(target, torch.Tensor):
        return loaded.to(device=target.device, dtype=target.dtype)
    return loaded


def save(directory: str, step: int, state: Any, keep: int = 3) -> str:
    """Atomically write `state` for `step`; keep the newest `keep`
    checkpoints. Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_plain(state), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)   # atomic publish
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    for s in all_steps(directory)[:-keep]:
        try:
            os.unlink(_path(directory, s))
        except FileNotFoundError:
            pass
    return path


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT_RE.match,
                                                os.listdir(directory)) if m)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, target: Any = None,
            step: Optional[int] = None) -> Tuple[int, Any]:
    """(step, state) of the latest checkpoint (or of `step`), in the
    structure of `target` when one is given. Raises FileNotFoundError
    when there is none."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    state = torch.load(_path(directory, step), weights_only=True)
    return step, (state if target is None else _like(target, state))


def restore_or_init(directory: str, init_state: Any) -> Tuple[int, Any]:
    """Resume from the latest checkpoint, or (0, init_state) when none."""
    try:
        return restore(directory, init_state)
    except FileNotFoundError:
        return 0, init_state
