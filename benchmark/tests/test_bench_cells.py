"""A new configuration, traffic mix or metric is new files and entries in
BENCHMARK.json: the harness finds them by name, and no file of it changes."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark import cells, harness, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def digest(folder: Path) -> dict[str, str]:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(bench)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (bench / "configs" / "tiny-text.json").write_text(json.dumps(
        {"name": "tiny-text", "profile": "fast", "contents": "rdg", "match_proba": 0.8, "lit_proba": 0.3,
         "objects": {"a": 70_000, "b": 20_000}}))
    (bench / "traffic" / "halves-compress.json").write_text(json.dumps({"op": "compress", "why": "test"}))
    (bench / "end_to_end" / "requests_per_s.py").write_text(
        "def read(window):\n    return len(window.requests) / window.seconds\n")
    (bench / "metrics" / "kernel_s.compress.py").write_text(
        "def read(view):\n    return view.device_s_in_spans('kernel') or None\n")
    spec["configs"].append({"name": "tiny-text", "source": "test", "file": "benchmark/configs/tiny-text.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-text.halves-compress", "config": "tiny-text",
                              "traffic": "halves-compress", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "requests_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["tiny-text.halves-compress"]})
    spec["per_layer"].append({"name": "kernel_s.compress", "unit": "s", "better": "lower", "source": "device_trace",
                              "layer": "device", "moves": "compress_MBps", "workloads": ["tiny-text.halves-compress"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = cells.load(tmp_path, "tiny-text.halves-compress", bench_dir=bench)
    assert cell.config["objects"] == {"a": 70_000, "b": 20_000}
    # a metric with a `workloads` list is reported only in the cells it names
    assert [m.name for m in cell.end_to_end] == ["setup_s", "requests_per_s"]
    assert [m.name for m in cell.per_layer] == ["kernel_s.compress"]
    result = harness.run_cell(cell, 3, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"] and result["metrics"]["requests_per_s"]["value"] > 0
    units = traffic.units(cell.traffic, {"a": np.zeros(70_000, np.uint8), "b": np.zeros(20_000, np.uint8)})
    assert [u.size for u in units] == [70_000, 20_000]
    assert {k: v for k, v in digest(bench).items() if k in before} == before

    old = cells.load(tmp_path, "synth50-dense.whole-compress", bench_dir=bench)
    assert "requests_per_s" not in [m.name for m in old.end_to_end]
    assert "kernel_s.compress" not in [m.name for m in old.per_layer]


@pytest.mark.parametrize("bad", [{"clients": 17}, {"loop": "open"}, {"judge_share": 0.1}, {"op": "roundtrip"}])
def test_a_traffic_file_the_harness_cannot_run_is_refused(tmp_path, bad):
    """A key the harness does not read, an op it has not, or more clients
    than it runs, stops the load before any run: a mix never runs as
    something other than it says."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "traffic" / "whole-compress.json").write_text(json.dumps({"op": "compress", "why": "test"} | bad))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    with pytest.raises(ValueError):
        cells.load(tmp_path, "synth50-fast.whole-compress", bench_dir=bench)
