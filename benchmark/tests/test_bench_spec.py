"""BENCHMARK.json keeps to the contract's shapes and characters, and a
configuration, a traffic mix or a metric added as files is found with no
edit."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from harness import spec
from helpers import copy_benchmark, with_train

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
B = spec.load()


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(B)) < 64 * 1024
    assert 1 <= B["run_seconds"] <= 51
    assert all(PATH.match(p) and ".." not in p for p in B["paths"])
    assert len(B["command"]) <= 32 and all(_text(w) for w in B["command"])


@pytest.mark.parametrize("b", [B, with_train(json.loads(json.dumps(B)))],
                         ids=["committed", "with_the_train_cell"])
def test_names_units_and_texts(b):
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and _text(m["layer"])
        for w in m["workloads"]:
            cell = spec.cell(b, w)
            assert m["moves"] in {e["name"] for e in cell["end_to_end"]}
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("b", [B, with_train(json.loads(json.dumps(B)))],
                         ids=["committed", "with_the_train_cell"])
def test_every_cell_finds_its_files(b):
    for w in b["workloads"]:
        cell = spec.cell(b, w["name"])
        assert cell["end_to_end"] and cell["per_layer"]
        assert "setup_s" in {m["name"] for m in cell["end_to_end"]}
        for m in cell["per_layer"]:
            assert callable(spec.reader(m["name"]))
        assert (spec.BENCH / "limits" / f"{w['name']}.json").exists()


@pytest.fixture
def copy(tmp_path):
    """The benchmark alone (BENCHMARK.json and benchmark/) in a fresh
    directory."""
    return copy_benchmark(tmp_path)


def test_a_cell_mix_and_metric_added_as_files(copy):
    b = json.loads((copy / "BENCHMARK.json").read_text())
    mix = json.loads((copy / "benchmark/traffic/orbit.json").read_text())
    mix.update(yaw_deg_per_frame=0.0, why="a still camera")
    (copy / "benchmark/traffic/fixate.json").write_text(json.dumps(mix))
    (copy / "benchmark/metrics/frames_traced.view.py").write_text(
        "def read(rec):\n    return float(rec['units'])\n")
    shutil.copy(copy / "benchmark/limits/earth-uhd.orbit.json",
                copy / "benchmark/limits/earth-uhd.fixate.json")
    b["workloads"].append({"name": "earth-uhd.fixate", "config": "earth-uhd",
                           "traffic": "fixate", "chips": 1, "why": "still"})
    for m in b["end_to_end"]:
        if "workloads" in m and "earth-uhd.orbit" in m["workloads"]:
            m["workloads"].append("earth-uhd.fixate")
    b["per_layer"].append({"name": "frames_traced.view", "unit": "frames",
                           "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": "frame_ms",
                           "workloads": ["earth-uhd.fixate"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.cell(b, "earth-uhd.fixate", copy)
    assert cell["mix"]["yaw_deg_per_frame"] == 0.0
    assert [m["name"] for m in cell["per_layer"]] == ["frames_traced.view"]
    assert spec.reader("frames_traced.view", copy / "benchmark")(
        {"units": 3}) == 3.0
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "earth-uhd.fixate",
         "--seed", "5", "--seconds", "0.5", "--trace", "1", "--device",
         "cpu", "--size", "32x32"], cwd=copy, capture_output=True, text=True,
        env={"PYTHONPATH": str(spec.REPO), "PATH": "/usr/bin:/bin",
             "HOME": str(copy)}, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["frames_traced.view"]["value"] == 3.0
    assert line["correct"] is True


def test_no_result_without_the_program(copy):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "earth-uhd.orbit",
         "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu",
         "--size", "32x32"], cwd=copy, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(copy)}, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_no_result_without_a_card(copy, monkeypatch):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "earth-uhd.orbit",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=copy,
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(spec.REPO), "PATH": "/usr/bin:/bin",
             "HOME": str(copy), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and not out.stdout.strip()
