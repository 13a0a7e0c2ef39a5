"""Build-at-first-use (fovtrace_torch/_build.py): a library is built once,
its compiler output is kept beside it, and a library without that log is
built again, so any run can read the log (chip_smoke.py's spill check
does). Uses g++ on a one-line C source. Also the cluster kernels' ctypes
signatures against their C source, and that spill check on a written
log."""

import ctypes
import re
from pathlib import Path

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


def _c_entry_points(src: str) -> dict:
    """{name: [c_void_p or c_int per parameter]} of the `extern "C"`
    functions of a kernel source: pointers and the stream are c_void_p,
    ints c_int."""
    block = src[src.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"\nint (fov_\w+)\(([^)]*)\)\s*\{", block):
        params = [" ".join(p.split()) for p in m.group(2).split(",")]
        out[m.group(1)] = [
            ctypes.c_void_p if "*" in p or p.startswith("cudaStream_t")
            else ctypes.c_int if p.startswith("int ") else None
            for p in params]
    return out


def test_kernel_bindings_match_the_c_entry_points():
    """Every C entry point of the cluster kernel library has the ctypes
    signature the wrapper gives it: the same count of pointers and ints
    in the same order (a mismatch would pass a pointer as an int on the
    card, where it shows only as a wrong result or a fault)."""
    from fovtrace_torch.kernels import cluster_isect as ci

    want = _c_entry_points(ci._CSRC.read_text())
    got = ci.c_signatures()
    assert sorted(want) == sorted(got)
    for name, (argtypes, restype) in got.items():
        assert None not in want[name], (name, want[name])
        assert argtypes == want[name], name
        assert restype is ctypes.c_int
    # the resident pair takes the ticket order and counter and ray_visited
    assert len(got["fov_closest_hit"][0]) == 15
    assert len(got["fov_occlusion"][0]) == 18


def _ptxas_log(kernels):
    """A `ptxas -v` log of the cluster library: {short name: spill store
    bytes}."""
    pre = "_ZN49_GLOBAL__N__ccd68d88_16_cluster_isect_cu_f4dfb949"
    out = []
    for name, spill in kernels.items():
        fn = f"{pre}{len(name)}{name}EPKfS1_PKiS3_S1_PfPiS5_S5_iiiiii"
        out += [f"ptxas info    : Compiling entry function '{fn}' for "
                "'sm_90a'",
                f"ptxas info    : Function properties for {fn}",
                f"    {spill // 2} bytes stack frame, {spill} bytes spill "
                f"stores, {spill} bytes spill loads",
                "ptxas info    : Used 96 registers, used 1 barriers"]
    return "\n".join(out) + "\n"


def test_spill_gate_reads_the_render_kernels():
    """chip_smoke.py's [build] gate finds the render path's four cluster
    kernels in a ptxas log by name, reports their spills, and fails when
    one of them is missing from the log."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    spilled = dict.fromkeys(smoke.RENDER_KERNELS, 0)
    spilled["occlusion_kernel"] = 64
    got = smoke.render_spills(_ptxas_log({**spilled, "micro_kernel": 8}))
    assert got == {k: (v, v) for k, v in spilled.items()}
    del spilled["closest_kernel"]
    with pytest.raises(AssertionError, match="four render-path"):
        smoke.render_spills(_ptxas_log(spilled))
