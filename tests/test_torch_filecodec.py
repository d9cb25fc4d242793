"""The port's bounded-memory file codec (device="cpu") against the JAX
package's, on the legs of tests/test_filecodec.py: byte-equal compressed
files, multi-window round trips, empty and corrupt files, the
oversized-compressed-block fallback through the windowed decoder, and a
valid copy across the 64 KiB grid, which the port decodes."""

import numpy as np
import pytest

from snappytpu import api as jax_api
from snappytpu.bench import corpus
from snappytpu.format.varint import encode_varint
from snappytpu.stream import filecodec as jax_filecodec
from snappytpu_torch import api
from snappytpu_torch.model.decode import CorruptError  # the port's own: the file codec raises it
from snappytpu_torch.stream import filecodec, framing


@pytest.mark.parametrize("nbytes", [0, 1, 65536, 3 * 65536 + 17, 9 * 65536 + 1])
def test_compress_file_byte_equal(tmp_path, nbytes):
    """compress_file through 2-block windows == the port's api.compress of
    the whole buffer == the JAX package's compress_file."""
    data = corpus.mixed(nbytes, seed=31) if nbytes else b""
    src = tmp_path / "in.raw"
    src.write_bytes(data)
    n = filecodec.compress_file(src, tmp_path / "port.snappy", window_blocks=2, device="cpu")
    jax_filecodec.compress_file(src, tmp_path / "jax.snappy", window_blocks=2)
    got = (tmp_path / "port.snappy").read_bytes()
    assert got == api.compress(data, device="cpu")
    assert got == (tmp_path / "jax.snappy").read_bytes()
    assert n == len(got)


def test_multiwindow_round_trip(tmp_path):
    data = corpus.mixed(7 * 65536 + 123, seed=32)
    src, comp, out = tmp_path / "in.raw", tmp_path / "c.snappy", tmp_path / "out.raw"
    src.write_bytes(data)
    filecodec.compress_file(src, comp, profile="fast", window_blocks=3, device="cpu")
    assert comp.read_bytes() == jax_api.compress(data, "fast")
    assert filecodec.decompress_file(comp, out, window_blocks=2, device="cpu") == len(data)
    assert out.read_bytes() == data


def test_empty_and_corrupt_files(tmp_path):
    comp, out = tmp_path / "c.snappy", tmp_path / "out.raw"
    comp.write_bytes(encode_varint(0))
    assert filecodec.decompress_file(comp, out, device="cpu") == 0
    assert out.read_bytes() == b""
    comp.write_bytes(encode_varint(0) + b"\x00")
    with pytest.raises(CorruptError):
        filecodec.decompress_file(comp, out, device="cpu")

    # a flipped byte may leave a valid stream (other literal bytes): the
    # port must then decode what the JAX package decodes, else both reject
    data = corpus.mixed(130_000, seed=33)
    stream = bytearray(api.compress(data, device="cpu"))
    stream[len(stream) // 2] ^= 0x55
    comp.write_bytes(bytes(stream))
    try:
        want = jax_api.decompress(bytes(stream))
    except ValueError:
        with pytest.raises(ValueError):
            filecodec.decompress_file(comp, out, window_blocks=1, device="cpu")
    else:
        assert filecodec.decompress_file(comp, out, window_blocks=1, device="cpu") == len(data)
        assert out.read_bytes() == want != data
    stream[5] ^= 0xFF  # a second flip, in the first op's header: malformed for both packages
    comp.write_bytes(bytes(stream))
    with pytest.raises(ValueError):
        jax_api.decompress(bytes(stream))
    with pytest.raises(ValueError):
        filecodec.decompress_file(comp, out, window_blocks=1, device="cpu")


def test_oversized_compressed_block_goes_to_the_windowed_decoder(tmp_path, monkeypatch):
    """All 1-byte literals: 2 compressed bytes per output byte, more than a
    compressed row per 64 KiB block; decompress_file decodes it through the
    in-memory route, whose windowed decoder K4 (plain version) runs."""
    data = corpus.mixed(2 * 65536 + 100, seed=33)
    stream = encode_varint(len(data)) + bytes(b for x in data for b in (0x00, x))
    comp, out = tmp_path / "c.snappy", tmp_path / "out.raw"
    comp.write_bytes(stream)
    calls = []
    real = api.decode_stream_vm
    monkeypatch.setattr(api, "decode_stream_vm", lambda *a: calls.append(a[0].shape[0]) or real(*a))
    assert filecodec.decompress_file(comp, out, window_blocks=1, device="cpu") == len(data)
    assert out.read_bytes() == data
    assert calls and sum(calls) >= 4


@pytest.mark.parametrize("window_blocks", [1, 2])
def test_a_copy_across_the_grid_decodes_as_in_memory(tmp_path, window_blocks):
    """A valid stream whose copy opens block 1 and reaches 500 bytes back
    into block 0, which raw Snappy allows: the tape decoder flags block 1
    not ok, and decompress_file hands the stream to api.decompress, which
    decodes it through the windowed route; the JAX package rejects it."""
    head = corpus.mixed(65536, seed=34)
    rest = corpus.mixed(65536 - 40 + 300, seed=35)
    want = head + head[-500:-460] + rest
    _, start = framing.read_preamble(np.frombuffer(api.compress(head, "fast", device="cpu"), np.uint8))
    ops = api.compress(head, "fast", device="cpu")[start:]
    cut = 65536 - 40  # literals that end at the grid
    stream = (encode_varint(len(want)) + ops + bytes([2 | (39 << 2)]) + (500).to_bytes(2, "little")
              + bytes([61 << 2]) + (cut - 1).to_bytes(2, "little") + rest[:cut]
              + bytes([61 << 2]) + (len(rest) - cut - 1).to_bytes(2, "little") + rest[cut:])
    comp, out = tmp_path / "c.snappy", tmp_path / "out.raw"
    comp.write_bytes(stream)
    assert api.decompress(stream, device="cpu") == want
    with pytest.raises(ValueError):
        jax_api.decompress(stream)
    assert filecodec.decompress_file(comp, out, window_blocks=window_blocks, device="cpu") == len(want)
    assert out.read_bytes() == want
