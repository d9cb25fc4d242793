"""The port's CLI (python -m snappytpu_torch.cli) with --device cpu: the
reference-compatible -c / -b / -d flags, the roundtrip verb, the host
backends and the --window-mb file-codec leg of tests/test_filecodec.py."""

import pytest
import torch

from snappytpu import api as jax_api
from snappytpu.bench import corpus
from snappytpu_torch import api, cli

DATA = corpus.mixed(200_000, seed=34)


@pytest.fixture
def paths(tmp_path):
    src = tmp_path / "in.raw"
    src.write_bytes(DATA)
    return src, tmp_path / "c.snappy", tmp_path / "out.raw"


@pytest.mark.parametrize("flag, profile", [("-c", "fast"), ("-b", "dense")])
def test_compress_then_decompress(paths, flag, profile):
    src, comp, out = paths
    assert cli.main([flag, str(src), str(comp), "--device", "cpu"]) == 0
    assert comp.read_bytes() == api.compress(DATA, profile, device="cpu")
    assert cli.main(["-d", str(comp), str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == DATA


def test_roundtrip_verb(paths, capsys):
    src, _, _ = paths
    assert cli.main(["roundtrip", str(src), "--device", "cpu"]) == 0
    assert "roundtrip ok: 200000 bytes" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["cpu", "model"])
def test_host_backends_interoperate(paths, backend):
    src, comp, out = paths
    assert cli.main(["-c", str(src), str(comp), "--backend", backend]) == 0
    assert cli.main(["-d", str(comp), str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == DATA


def test_window_flag_goes_through_the_file_codec(paths, monkeypatch):
    from snappytpu_torch.stream import filecodec

    src, comp, out = paths
    used = []
    for name in ("compress_file", "decompress_file"):
        real = getattr(filecodec, name)
        monkeypatch.setattr(filecodec, name, lambda *a, _r=real, _n=name, **k: used.append(_n) or _r(*a, **k))
    assert cli.main(["-b", str(src), str(comp), "--window-mb", "1", "--device", "cpu", "-r"]) == 0
    assert cli.main(["-d", str(comp), str(out), "--window-mb", "1", "--device", "cpu"]) == 0
    assert used == ["compress_file", "decompress_file"]
    assert out.read_bytes() == DATA
    assert comp.read_bytes() == jax_api.compress(DATA)


def test_cuda_device_without_a_gpu_is_refused(paths, monkeypatch):
    src, comp, _ = paths
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.main(["-c", str(src), str(comp)])
    assert not comp.exists()
