"""Find a cell's parts by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file is the one its `configs` entry names; the traffic
mix is `traffic/<name>.json`; each metric is read by `end_to_end/<name>.py`
or `metrics/<name>.py`, a module with `read(record) -> float | None`.  So a
new configuration, traffic mix or metric is a new file and a new entry in
BENCHMARK.json, and nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

from . import traffic as traffic_mix

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    reader: ModuleType


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple[Metric, ...]
    per_layer: tuple[Metric, ...]


def _reader(folder: Path, name: str) -> ModuleType:
    path = folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_reader_{folder.name}_{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _metrics(entries: list[dict], cell: str, folder: Path) -> tuple[Metric, ...]:
    """The metrics of `entries` that `cell` reports: those without a
    `workloads` list, and those whose list names it."""
    return tuple(Metric(m["name"], m["unit"], _reader(folder, m["name"]))
                 for m in entries if cell in m.get("workloads", [cell]))


def load(root: Path, workload: str, bench_dir: Path = HERE) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json, its files under `bench_dir`."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = traffic_mix.check(json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text()))
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=_metrics(spec["end_to_end"], workload, bench_dir / "end_to_end"),
        per_layer=_metrics(spec["per_layer"], workload, bench_dir / "metrics"),
    )
