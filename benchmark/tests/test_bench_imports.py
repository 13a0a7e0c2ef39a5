"""Nothing the benchmark loads is JAX or the JAX package: the check
compares each module's top-level name (before the first dot) whole."""

import json
import subprocess
import sys

from harness import spec


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run

    for ok in ("fovtrace_torch", "fovtrace_torch.render.pipeline",
               "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, ok, sys)
    assert run.forbidden_modules() == []
    for bad in ("fovtrace", "fovtrace.render", "jax.numpy", "jaxlib",
                "flax.linen"):
        monkeypatch.setitem(sys.modules, bad, sys)
    assert run.forbidden_modules() == sorted(
        ["fovtrace", "fovtrace.render", "jax.numpy", "jaxlib", "flax.linen"])


def test_harness_and_reference_load_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, calibrate\n"
        "from harness import arith, check, faults, program, refside, report,"
        " scenes, spec, trace, trainer, traffic, viewer\n"
        "import reference.pipeline, reference.train\n"
        "print(run.forbidden_modules())" % (str(spec.BENCH), str(spec.REPO)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_ends_with_no_jax_loaded():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "earth-uhd.orbit",
         "--seed", "21", "--seconds", "0.5", "--trace", "0", "--device",
         "cpu", "--size", "32x32"], cwd=spec.REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True


def test_reference_sources_import_nothing_of_the_program():
    for path in (spec.BENCH / "reference").glob("*.py"):
        text = path.read_text()
        for word in ("import fovtrace", "from fovtrace", "import jax",
                     "from jax"):
            assert word not in text, (path.name, word)
