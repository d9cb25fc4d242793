"""The harness end to end on the CPU at a tiny size, and what it must not load."""

import ast
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness, run

ROOT = Path(__file__).resolve().parents[2]
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
HOST_LAYER = {m["name"] for m in SPEC["per_layer"] if m["source"] == "host_clock"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload,op", [(w, None) for w in WORKLOADS] + [(WORKLOADS[-1], "decompress")])
def test_dry_run_prints_the_contracts_line(workload, op, trace, tiny):
    cell = tiny(workload, op=op)
    result = harness.run_cell(cell, 2**40 + 9, 0.3, bool(trace), "cpu", time.perf_counter())
    out, err = io.StringIO(), io.StringIO()
    run.emit(result, out, err)
    line = json.loads(out.getvalue().splitlines()[-1])
    keys = CONTRACT + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    if trace:  # a CPU trace has no card: only the per-layer metrics on the host's clock are written
        names = [m.name for m in cell.per_layer if m.name in HOST_LAYER]
        assert set(line["metrics"]) <= set(names) and (op is not None or list(line["metrics"]) == names)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    elif op is None:
        assert list(line["metrics"]) == [m.name for m in cell.end_to_end]
    else:  # a compress cell's metrics of the other op read nothing in a decompress run
        assert list(line["metrics"]) == [m.name for m in cell.end_to_end if m.name not in ("compress_MBps", "ratio")]
        assert {"p95_ms", "setup_s"} <= set(line["metrics"])
        assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in line["metrics"].values())
    assert err.getvalue().splitlines() == [f"check {k}: {v['value']} (limit {v['limit']})"
                                           for k, v in line["checks"].items()]


def test_the_command_refuses_without_a_card(no_card, tmp_path):
    """No result and a nonzero exit without a card, and in a directory that
    holds only BENCHMARK.json and the benchmark's folder."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0], "--seed", str(2**33),
                            "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and r.stdout == "", (r.returncode, r.stdout[-500:])


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add((node.module or "").split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark").rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("name", ["reference.py", "datagen.py"])
def test_the_reference_imports_nothing_of_the_program(name):
    assert "snappytpu_torch" not in _top_level_imports(ROOT / "benchmark" / name)


def _loaded_after(code: str) -> set[str]:
    probe = f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; print(sorted({{m.split('.')[0] for m in sys.modules}}))"
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(eval(r.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program():
    ran = _loaded_after(
        "import time, json, dataclasses; from benchmark import cells, harness; from pathlib import Path; "
        f"root = Path({str(ROOT)!r}); c = cells.load(root, 'synth50-fast.whole-compress'); "
        "c = dataclasses.replace(c, config=c.config | {'objects': {'a': 90000}}, traffic={'op': 'decompress'}); "
        "r = harness.run_cell(c, 5, 0.2, False, 'cpu', time.perf_counter()); assert r['correct']")
    assert "snappytpu_torch" in ran and not ran & set(harness.FORBIDDEN)
    ref = _loaded_after(
        "from benchmark import reference, datagen; g = datagen._generator(1, 'cpu'); "
        "reference.decode(b'\\x03\\x08abc', 'cpu'); datagen.rdg(10000, g, 'cpu')")
    assert not ref & (set(harness.FORBIDDEN) | {"snappytpu_torch"})
