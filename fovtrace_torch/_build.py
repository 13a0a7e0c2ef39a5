"""Build-at-first-use for the port's native libraries.

Each library is compiled from sources in the checkout into
`<checkout>/build/fovtrace_torch/`, under a file name that carries a hash
of its sources and compiler command, so an edited source (or flag) gets
a fresh build and an unchanged one is reused. The compile writes to a
temporary name and renames it into place, so concurrent processes never
load a half-written library. Each library has its own lock, so threads
building different libraries run their compilers at the same time.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Sequence

REPO_ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = REPO_ROOT / "build" / "fovtrace_torch"

_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
# compiler output of each library built by this process (ptxas register
# and shared-memory reports for the CUDA kernels)
build_logs: Dict[str, str] = {}


def _host_tag() -> str:
    """The CPU model: host code is compiled with -march=native, so a
    library built on one machine must not be reused on another."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def build_library(name: str, sources: Sequence[Path],
                  command: Callable[[List[str], str], List[str]]) -> Path:
    """Path of lib`name`-<hash>.so, compiling it first if needed.

    `command(sources, out_path)` returns the compiler argv."""
    srcs = [str(Path(s)) for s in sources]
    h = hashlib.sha256()
    for s in srcs:
        h.update(Path(s).read_bytes())
    h.update(" ".join(command(["<src>"], "<out>")).encode())
    h.update(_host_tag().encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(command(srcs, str(tmp)), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        build_logs[name] = proc.stdout + proc.stderr
        os.replace(tmp, out)
        return out
