"""The port's mesh-overhead tools (snappytpu_torch.tools.mesh_device_bench
and mesh_stage_probe) on a one-slot CPU mesh at --b 4 --nq 1: the
mesh1-device CSV rows in the JAX tool's schema, the mesh's outputs equal
to the direct calls' (a mesh that differs fails the tool), the four encoder
prefixes logged, and no run without a card when CUDA is asked for."""

import csv
import os
import re

import pytest
import torch

from snappytpu.bench import metrics as jax_metrics
from snappytpu_torch.kernels import encode_v2 as E
from snappytpu_torch.mesh import sharding
from snappytpu_torch.tools import _staged, mesh_device_bench, mesh_stage_probe

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

SMALL = ["--b", "4", "--nq", "1", "--device", "cpu"]


def _rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == jax_metrics.CSV_FIELDS
    return [dict(zip(rows[0], r)) for r in rows[1:]]


@pytest.mark.parametrize("profile", ["fast", "dense"])
def test_mesh_device_bench_rows(tmp_path, capsys, profile):
    assert mesh_device_bench.main(SMALL + ["--profile", profile, "--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    for what in (f"encode {profile}", "decode"):
        assert any(re.search(rf"\] {what}: direct +[0-9.]+ ms/batch .* mesh1 +[0-9.]+ ms/batch .* overhead +[-+][0-9.]+ "
                             rf"ms \([-+][0-9.]+%\)$", ln) for ln in lines), what
    assert lines[-1].endswith("DONE")
    assert sorted(os.listdir(tmp_path)) == [f"compression_results_mesh1_device_{profile}.csv",
                                            f"decompression_results_mesh1_device_{profile}.csv"]
    (c,) = _rows(tmp_path / f"compression_results_mesh1_device_{profile}.csv")
    (d,) = _rows(tmp_path / f"decompression_results_mesh1_device_{profile}.csv")
    ((b, n),) = _staged.encoder_sets(4, 1, "cpu")
    total = int(E.encode_block_core(b, n, profile == "dense")[1].sum())
    assert (c["input_size"], c["output_size"], c["phase"], c["backend"]) == (str(4 << 16), str(total), "compress",
                                                                             "device-mesh1")
    assert (d["input_size"], d["output_size"], d["phase"], d["backend"]) == (str(total), str(4 << 16), "decompress",
                                                                             "device-mesh1")
    assert (c["n_chips"], c["n_hosts"]) == ("1", "1")


@pytest.mark.parametrize("call", ["sharded_encode", "sharded_decode"])
def test_mesh_device_bench_refuses_a_mesh_that_differs(tmp_path, monkeypatch, call):
    real = getattr(sharding, call)

    def wrong(*a):
        run = real(*a)

        def flipped(*shards):
            out = run(*shards)
            out[0][0] = out[0][0].clone()
            out[0][0][0, 3] ^= 1
            return out

        return flipped

    monkeypatch.setattr(sharding, call, wrong)
    with pytest.raises(AssertionError, match="the mesh's outputs differ from the direct call's"):
        mesh_device_bench.main(SMALL + ["--out", str(tmp_path)])


@pytest.mark.parametrize("case", ["fewer_batches", "fewer_outputs", "extra_shard"])
def test_mesh_device_bench_refuses_a_mesh_of_another_shape(case):
    """Equal where both have outputs, but the mesh gives fewer batches,
    fewer outputs or an extra shard: refused all the same."""
    x, y = torch.arange(4), torch.arange(3)
    direct = [(x, y), (x, y)]
    mesh = {"fewer_batches": [([x], [y])], "fewer_outputs": [([x], [y]), ([x],)],
            "extra_shard": [([x], [y]), ([x, x], [y])]}[case]
    mesh_device_bench._same("decode", direct, [([x], [y]), ([x], [y])])
    with pytest.raises(AssertionError, match="mesh"):
        mesh_device_bench._same("decode", direct, mesh)


def test_mesh_stage_probe_logs_four_prefixes(capsys):
    assert mesh_stage_probe.main(SMALL) == 0
    lines = capsys.readouterr().out.splitlines()
    found = [re.search(r"\] (\w+) +direct +[0-9.]+ ms  mesh1 +[0-9.]+ ms  delta +[-+][0-9.]+ ms \([-+][0-9.]+%\)$", ln)
             for ln in lines]
    assert [m.group(1) for m in found if m] == ["find", "elect", "reglue", "full"] == list(mesh_stage_probe.PREFIXES)
    assert lines[-1].endswith("DONE")


def test_stage_prefix_reductions():
    """Each prefix reduces its stage's outputs per block; the full prefix is
    the encoder's totals plus a sample of its rows."""
    ((b, n),) = _staged.encoder_sets(2, 1, "cpu")
    comp, totals = E.encode_block_core(b, n, False)
    (full,) = mesh_stage_probe.prefix_fn("full", False)(b, n)
    assert torch.equal(full, totals.long() + comp[:, ::997].long().sum(1))
    for upto in mesh_stage_probe.PREFIXES:
        (r,) = mesh_stage_probe.prefix_fn(upto, False)(b, n)
        assert r.shape == (2,) and r.dtype == torch.int64 and bool((r > 0).all()), upto


@pytest.mark.parametrize("tool", [mesh_device_bench, mesh_stage_probe], ids=["mesh_device_bench", "mesh_stage_probe"])
def test_cuda_without_a_card_raises(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--device", "cuda"] + (["--out", str(tmp_path / "never")] if tool is mesh_device_bench else [])
    with pytest.raises(RuntimeError, match="is_available"):
        tool.main(argv)
    assert not (tmp_path / "never").exists()
