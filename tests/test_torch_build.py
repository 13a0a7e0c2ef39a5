"""Build-at-first-use (fovtrace_torch/_build.py): a library is built once,
its compiler output is kept beside it, and a library without that log is
built again, so any run can read the log (chip_smoke.py's spill check
does). Uses g++ on a one-line C source."""

import ctypes

import pytest
import torch

from fovtrace_torch import _build


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # the suite runs in several worker processes at once
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _compile(srcs, out):
    # -v: the compiler writes its version and commands to stderr
    return ["g++", "-v", "-O1", "-fPIC", "-shared", "-o", out, *srcs]


@pytest.fixture
def source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "one.cpp"
    src.write_text('extern "C" int fov_one() { return 1; }\n')
    return src


def test_library_keeps_its_compiler_log(source):
    path = _build.build_library("fovtest", [source], _compile)
    assert path.exists() and path.suffix == ".so"
    log = _build.build_log(path)
    assert "g++" in log or "gcc" in log
    assert ctypes.CDLL(str(path)).fov_one() == 1
    # reused: neither file is written again
    stamp = (path.stat().st_mtime_ns, path.with_suffix(".log").stat()
             .st_mtime_ns)
    assert _build.build_library("fovtest", [source], _compile) == path
    assert (path.stat().st_mtime_ns,
            path.with_suffix(".log").stat().st_mtime_ns) == stamp
    assert sorted(p.suffix for p in path.parent.iterdir()) == [".log", ".so"]


def test_library_without_log_is_rebuilt(source):
    path = _build.build_library("fovtest", [source], _compile)
    path.with_suffix(".log").unlink()
    with pytest.raises(FileNotFoundError):
        _build.build_log(path)
    assert _build.build_library("fovtest", [source], _compile) == path
    assert "g++" in _build.build_log(path) or "gcc" in _build.build_log(path)
    # an edited source is a new library
    source.write_text('extern "C" int fov_one() { return 2; }\n')
    other = _build.build_library("fovtest", [source], _compile)
    assert other != path and ctypes.CDLL(str(other)).fov_one() == 2
