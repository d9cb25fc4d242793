"""The port's CSV size sweep (snappytpu_torch.bench.sweep) on the CPU at
sizes 500 and 5000, and with a 1 MB Silesia-stand-in point: the `device`
backend, the native `cpu` backend and the mesh over two CPU shards write
the JAX sweep's CSV series (same file names, header and columns), round
trips asserted.  The `cpu` backend's rows equal the JAX sweep's in every
column that is not a time; the device backend's and the mesh's sizes equal
the port API's streams."""

import csv
import os

import pytest
import torch

from snappytpu.bench import sweep as jax_sweep
from snappytpu_torch import api, cpu
from snappytpu_torch.bench import corpus, sweep

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

SIZES = [500, 5000]
TIMES = ("time_taken", "speed")


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _series(out_dir, tag):
    return [os.path.join(out_dir, f"{phase}_results_{tag}.csv") for phase in ("compression", "decompression")]


@pytest.mark.parametrize("kw,tag", [
    (dict(backend="device"), "device_dense"),
    (dict(backend="device", profile="fast"), "device_fast"),
    (dict(mesh=True, mesh_shards=2), "mesh2_dense"),
    (dict(mesh=True, mesh_shards=2, profile="fast"), "mesh2_fast"),
], ids=lambda x: x if isinstance(x, str) else None)
def test_device_and_mesh_series(tmp_path, kw, tag):
    results = sweep.run_sweep(str(tmp_path), sizes=SIZES, reps=1, device="cpu", **kw)
    assert sorted(os.listdir(tmp_path)) == sorted(os.path.basename(p) for p in _series(tmp_path, tag))
    comp_rows, dec_rows = (_rows(p) for p in _series(tmp_path, tag))
    profile = kw.get("profile", "dense")
    for size, c, d in zip(SIZES, comp_rows, dec_rows):
        stream = api.compress(corpus.mixed(size, seed=size), profile, device="cpu")
        assert (int(c["input_size"]), int(c["output_size"])) == (size, len(stream))
        assert (int(d["input_size"]), int(d["output_size"])) == (len(stream), size)
        assert c["phase"] == "compress" and d["phase"] == "decompress"
        assert int(c["n_chips"]) == (2 if kw.get("mesh") else 1)
    assert [r.phase for r in results] == ["compress", "decompress"] * len(SIZES)


def test_cpu_series_equal_the_jax_sweep(tmp_path):
    if not cpu.available:
        pytest.skip("the native runtime needs g++")
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    sweep.run_sweep(str(mine), backend="cpu", sizes=SIZES, reps=1)
    jax_sweep.run_sweep("cpu", "dense", 1, str(theirs), sizes=SIZES)
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    for name in os.listdir(mine):
        with open(mine / name) as a, open(theirs / name) as b:
            assert a.readline() == b.readline(), name  # the header
        got, want = _rows(mine / name), _rows(theirs / name)
        assert len(got) == len(want) == len(SIZES)
        for g, w in zip(got, want):
            assert {k: v for k, v in g.items() if k not in TIMES} == {k: v for k, v in w.items() if k not in TIMES}


def test_cpu_series_with_a_real_file_point_equal_the_jax_sweep(tmp_path):
    if not cpu.available:
        pytest.skip("the native runtime needs g++")
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    sweep.run_sweep(str(mine), backend="cpu", sizes=[500], reps=1, real_file_mb=1)
    jax_sweep.run_sweep("cpu", "dense", 1, str(theirs), sizes=[500], real_file_mb=1)
    for name in os.listdir(theirs):
        got, want = _rows(mine / name), _rows(theirs / name)
        size = "input_size" if name.startswith("compression") else "output_size"
        assert [int(r[size]) for r in got] == [int(r[size]) for r in want] == [500, 1 << 20]
        for g, w in zip(got, want):
            assert {k: v for k, v in g.items() if k not in TIMES} == {k: v for k, v in w.items() if k not in TIMES}


@pytest.mark.parametrize("kw,tag", [
    (dict(backend="device", profile="fast"), "device_fast"),
    (dict(mesh=True, mesh_shards=2, profile="fast"), "mesh2_fast"),
], ids=["device", "mesh"])
def test_real_file_point_on_the_device_and_the_mesh(tmp_path, kw, tag):
    """The stand-in's point comes after the grid, its stream the port API's."""
    sweep.run_sweep(str(tmp_path), sizes=[500], reps=1, real_file_mb=1, device="cpu", **kw)
    comp_rows, dec_rows = (_rows(p) for p in _series(tmp_path, tag))
    stream = api.compress(corpus.silesia_standin(1 << 20), "fast", device="cpu")
    assert [int(r["input_size"]) for r in comp_rows] == [500, 1 << 20]
    assert (int(comp_rows[1]["output_size"]), int(dec_rows[1]["input_size"])) == (len(stream), len(stream))
    assert int(dec_rows[1]["output_size"]) == 1 << 20


def test_the_caller_names_the_directory():
    with pytest.raises(SystemExit):
        sweep.main(["--backend", "cpu"])


def test_main_writes_where_it_is_told(tmp_path, capsys):
    if not cpu.available:
        pytest.skip("the native runtime needs g++")
    sweep.main(["--backend", "cpu", "--reps", "1", "--out", str(tmp_path)])
    assert "compress: 1000000 ->" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["compression_results_cpu_dense.csv", "decompression_results_cpu_dense.csv"]
    assert len(_rows(tmp_path / "compression_results_cpu_dense.csv")) == len(sweep.SIZES)
