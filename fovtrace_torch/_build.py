"""Build-at-first-use for the port's native libraries.

Each library is compiled from sources in the checkout into
`<checkout>/build/fovtrace_torch/`, under a file name that carries a hash
of its sources and compiler command, so an edited source (or flag) gets
a fresh build and an unchanged one is reused. The compile writes to a
temporary name and renames it into place, so concurrent processes never
load a half-written library. The compiler's output (for the CUDA
kernels, ptxas's registers, spills and shared memory per kernel) is kept
beside the library as lib<name>-<hash>.log (`build_log`), so any later
run can read it. Each library has its own lock, so threads building
different libraries run their compilers at the same time.
"""

from __future__ import annotations

import ctypes
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
                  command: Callable[[List[str], str], List[str]],
                  headers: Sequence[Path] = ()) -> Path:
    """Path of lib`name`-<hash>.so, compiling it first if needed.

    `command(sources, out_path)` returns the compiler argv; `headers`
    are the files the sources include, hashed with them."""
    srcs = [str(Path(s)) for s in sources]
    h = hashlib.sha256()
    for s in [*srcs, *headers]:
        h.update(Path(s).read_bytes())
    h.update(" ".join(command(["<src>"], "<out>")).encode())
    h.update(_host_tag().encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if out.exists() and log.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(command(srcs, str(tmp)), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        # the log first: a library in place always has its log
        tmp_log = log.with_suffix(f".{os.getpid()}.tmplog")
        tmp_log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp_log, log)
        os.replace(tmp, out)
        return out


def load_library(name: str, sources: Sequence[Path],
                 command: Callable[[List[str], str], List[str]],
                 signatures: Dict[str, tuple],
                 headers: Sequence[Path] = ()) -> ctypes.CDLL:
    """The library that `build_library` builds, loaded by ctypes, each
    C entry point given its (argtypes, restype) from `signatures`."""
    lib = ctypes.CDLL(str(build_library(name, sources, command, headers)))
    for fn_name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def build_log(library: Path) -> str:
    """The compiler output kept beside a library that `build_library`
    built."""
    return Path(library).with_suffix(".log").read_text()
