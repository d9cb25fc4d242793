"""The port's shard manifests against snappytpu.stream.manifest: the legs of
tests/test_manifest.py (ordered assembly, idempotent reruns, a changed
input, failure detection, the default encoder), plus the part and manifest
files of both modules byte for byte on the same encoder (tolerance 0)."""

import json
import os

import numpy as np
import pytest
import torch

from snappytpu import api as jax_api
from snappytpu.stream import manifest as jax_manifest
from snappytpu_torch import api
from snappytpu_torch.bench import corpus
from snappytpu_torch.format import constants as C
from snappytpu_torch.model import decompress, encode_block
from snappytpu_torch.stream import manifest

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side


def _np_encode_fn(blocks, lens):
    """The port's model-codec encode_fn, so these tests stay fast on CPU."""
    comp = np.zeros((blocks.shape[0], C.MAX_COMPRESSED_BLOCK_SIZE), np.uint8)
    totals = np.zeros(blocks.shape[0], np.int32)
    for i in range(blocks.shape[0]):
        b = encode_block(blocks[i, : lens[i]])
        comp[i, : len(b)] = np.frombuffer(b, np.uint8)
        totals[i] = len(b)
    return comp, totals


def test_shard_sweep_assemble_roundtrip(tmp_path):
    data = np.frombuffer(corpus.mixed(5 * 65536 + 321, seed=31), np.uint8)
    n_shards = 3
    for s in range(n_shards):
        manifest.encode_shard(data, str(tmp_path), s, n_shards, _np_encode_fn)
    assert manifest.missing_shards(str(tmp_path), n_shards) == []
    out = tmp_path / "full.snappy"
    total = manifest.assemble(str(tmp_path), n_shards, str(out))
    assert total == data.size
    assert decompress(out.read_bytes()) == data.tobytes()


def test_idempotent_rerun(tmp_path):
    data = np.frombuffer(corpus.text(3 * 65536), np.uint8)
    m1 = manifest.encode_shard(data, str(tmp_path), 0, 2, _np_encode_fn)
    part = tmp_path / "shard_00000.snappy_part"
    mtime = os.path.getmtime(part)
    m2 = manifest.encode_shard(data, str(tmp_path), 0, 2, _np_encode_fn)
    assert m1 == m2
    assert os.path.getmtime(part) == mtime  # nothing rewritten


def test_changed_input_recomputes(tmp_path):
    data = np.frombuffer(corpus.text(2 * 65536), np.uint8)
    manifest.encode_shard(data, str(tmp_path), 0, 1, _np_encode_fn)
    data2 = np.frombuffer(corpus.text(2 * 65536, seed=99), np.uint8)
    m = manifest.encode_shard(data2, str(tmp_path), 0, 1, _np_encode_fn)
    assert m["input_sha256"] != ""
    out = tmp_path / "full.snappy"
    manifest.assemble(str(tmp_path), 1, str(out))
    assert decompress(out.read_bytes()) == data2.tobytes()


def test_missing_shard_detected(tmp_path):
    data = np.frombuffer(corpus.text(4 * 65536), np.uint8)
    manifest.encode_shard(data, str(tmp_path), 0, 3, _np_encode_fn)
    manifest.encode_shard(data, str(tmp_path), 2, 3, _np_encode_fn)
    assert manifest.missing_shards(str(tmp_path), 3) == [1]
    # corrupt manifest counts as missing
    mp = tmp_path / "shard_00000.json"
    mp.write_text(json.dumps({"complete": False}))
    assert 0 in manifest.missing_shards(str(tmp_path), 3)
    with pytest.raises(RuntimeError, match=r"shards incomplete: \[0, 1\]"):
        manifest.assemble(str(tmp_path), 3, str(tmp_path / "full.snappy"))


def test_default_encoder_matches_api_compress(tmp_path):
    """The default (production) shard encoder, on device="cpu", yields the
    SAME bytes as the port's api.compress and the JAX api.compress: a
    manifest-assembled multi-shard stream is byte-identical to the
    single-host stream."""
    data = np.frombuffer(corpus.mixed(4 * 65536 + 777, seed=77), np.uint8)
    n_shards = 2
    for s in range(n_shards):
        manifest.encode_shard(data, str(tmp_path), s, n_shards, device="cpu")  # default fn
    out = tmp_path / "full.snappy"
    manifest.assemble(str(tmp_path), n_shards, str(out))
    stream = out.read_bytes()
    assert stream == api.compress(data.tobytes(), device="cpu")
    assert stream == jax_api.compress(data.tobytes())


def test_default_encoder_batches_of_at_most_128(monkeypatch, tmp_path):
    """The default encoder (api.encode_rows) makes device calls of at most
    128 blocks, dense, on the device it was given."""
    calls = []

    def fake(b, n, profile="dense"):
        calls.append((b.device.type, b.shape[0], profile))
        return torch.zeros((b.shape[0], C.MAX_COMPRESSED_BLOCK_SIZE), dtype=torch.uint8), torch.ones_like(n)

    monkeypatch.setattr(api, "encode_blocks", fake)
    m = manifest.encode_shard(np.zeros(300 * 65536, np.uint8), str(tmp_path), 0, 1, device="cpu")
    assert calls == [("cpu", 128, "dense"), ("cpu", 128, "dense"), ("cpu", 44, "dense")]
    assert m["block_comp_lens"] == [1] * 300 and (tmp_path / "shard_00000.snappy_part").read_bytes() == bytes(300)


def test_default_encoder_refuses_a_poisoned_block(monkeypatch, tmp_path):
    """No silent truncation: a block the encoder poisoned (total -1) raises
    CapacityError naming it, and the shard writes no part and no manifest."""
    real = api.encode_blocks

    def poisoned(b, n, profile="dense"):
        comp, totals = real(b, n, profile)
        return comp, torch.where(n == 777, -1, totals)

    monkeypatch.setattr(api, "encode_blocks", poisoned)
    data = np.frombuffer(corpus.text(2 * 65536 + 777), np.uint8)
    with pytest.raises(api.CapacityError, match=r"block\(s\) \[2\]"):
        manifest.encode_shard(data, str(tmp_path), 0, 1, device="cpu")
    assert os.listdir(tmp_path) == []
    assert manifest.missing_shards(str(tmp_path), 1) == [0]


@pytest.mark.parametrize("size,n_shards", [(0, 1), (65536, 2), (5 * 65536 + 321, 3), (7 * 65536 + 9, 4)])
def test_files_equal_the_jax_module(tmp_path, size, n_shards):
    """The same encoder through both modules: equal manifests, part files
    and assembled streams, block ranges included (an empty input, a shard
    that owns no block)."""
    data = np.frombuffer(corpus.mixed(size, seed=size), np.uint8)
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    for s in range(n_shards):
        assert manifest.shard_block_range(size, s, n_shards) == jax_manifest.shard_block_range(size, s, n_shards)
        assert (manifest.encode_shard(data, str(mine), s, n_shards, _np_encode_fn)
                == jax_manifest.encode_shard(data, str(theirs), s, n_shards, _np_encode_fn))
    assert manifest.assemble(str(mine), n_shards, str(mine / "full")) == jax_manifest.assemble(
        str(theirs), n_shards, str(theirs / "full"))
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    for name in os.listdir(mine):
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name
