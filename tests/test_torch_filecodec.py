"""The port's bounded-memory file codec (device="cpu") against the JAX
package's, on the legs of tests/test_filecodec.py: byte-equal compressed
files, multi-window round trips, empty and corrupt files, the
oversized-compressed-block fallback through the windowed decoder, and a
valid copy across the 64 KiB grid, which the port decodes.  The decoding
legs run on both of api.decompress's block routes, which the file codec
takes window by window: K5's host tapes (the CPU device's) and K2 after
the native split (a CUDA device's, forced here on the CPU device)."""

import numpy as np
import pytest

from snappytpu import api as jax_api
from snappytpu.bench import corpus
from snappytpu.format.varint import encode_varint
from snappytpu.stream import filecodec as jax_filecodec
from snappytpu_torch import api, cpu, hostbuf, profiling
from snappytpu_torch.format import constants as C
from snappytpu_torch.kernels import decode_tape
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


@pytest.fixture(params=["tape", "native+K2"])
def route(request, monkeypatch):
    """The block route the file codec's windows take: K5 on host tapes, or
    K2 after the native split (a CUDA device's route, forced here)."""
    if not cpu.available:
        pytest.skip("the file codec's window route needs the port's native runtime")
    if request.param == "native+K2":
        monkeypatch.setattr(api, "parses_on_card", lambda device: True)
    return request.param


def test_multiwindow_round_trip(tmp_path, route):
    data = corpus.mixed(7 * 65536 + 123, seed=32)
    src, comp, out = tmp_path / "in.raw", tmp_path / "c.snappy", tmp_path / "out.raw"
    src.write_bytes(data)
    filecodec.compress_file(src, comp, profile="fast", window_blocks=3, device="cpu")
    assert comp.read_bytes() == jax_api.compress(data, "fast")
    assert filecodec.decompress_file(comp, out, window_blocks=2, device="cpu") == len(data)
    assert out.read_bytes() == data


def test_empty_and_corrupt_files(tmp_path, route):
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
def test_a_copy_across_the_grid_decodes_as_in_memory(tmp_path, window_blocks, route):
    """A valid stream whose copy opens block 1 and reaches 500 bytes back
    into block 0, which raw Snappy allows: the block route flags block 1
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


def compressed_file(tmp_path, nbytes: int, seed: int):
    """(data, path of its fast stream)."""
    data = corpus.mixed(nbytes, seed=seed)
    comp = tmp_path / "c.snappy"
    comp.write_bytes(api.compress(data, "fast", device="cpu"))
    return data, comp


def test_a_multiwindow_file_counts_one_device_call_a_batch(tmp_path, route, monkeypatch):
    """8 blocks in windows of 3, 3 and 2, device calls of at most 2 blocks:
    5 calls, the same counters api.decompress keeps, K2's on its route."""
    data, comp = compressed_file(tmp_path, 7 * 65536 + 123, seed=36)
    monkeypatch.setattr(api, "DEVICE_BATCH", 2)
    profiling.reset_counters()
    try:
        assert filecodec.decompress_file(comp, tmp_path / "out.raw", window_blocks=3, device="cpu") == len(data)
        counts = {k: v for k, v in profiling.counters().items() if k.startswith("decompress.")}
    finally:  # the registry is the process's: later tests in this worker read it
        profiling.reset_counters()
    assert (tmp_path / "out.raw").read_bytes() == data
    k2 = {} if route == "tape" else {"decompress.k2_calls": 5}
    assert counts == {"decompress.device_calls": 5, "decompress.blocks": 8, **k2}


# each kept host buffer's bytes per block of a window: the padded rows and
# their lengths, K5's tapes, the decoded rows and the window's output
PER_BLOCK = {"api.rows": C.MAX_COMPRESSED_BLOCK_SIZE, "api.row_lens": 4, "api.d2h": C.MAX_BLOCK_SIZE,
             "filecodec.out": C.MAX_BLOCK_SIZE, "decode_tape.build": 8 * decode_tape.TAPE_MAX,
             "decode_tape.tapes": 8 * decode_tape.TAPE_MAX, "decode_tape.nrecs": 4}


@pytest.mark.parametrize("window_blocks", [1, 2])
def test_decompress_file_keeps_window_sized_buffers(tmp_path, route, window_blocks, monkeypatch):
    """Every host buffer decompress_file takes holds at most a window's
    blocks (rows at most window_blocks x 73,728 bytes, output at most
    window_blocks x 65,536), whatever the stream's length: none is the
    API's buffer for a whole decoded stream."""
    data, comp = compressed_file(tmp_path, 7 * 65536 + 123, seed=37)
    taken, take = [], hostbuf.take
    monkeypatch.setattr(hostbuf, "take", lambda name, shape, dtype, **kw: taken.append(
        (name, int(np.prod(shape)) * dtype.itemsize)) or take(name, shape, dtype, **kw))
    assert filecodec.decompress_file(comp, tmp_path / "out.raw", window_blocks=window_blocks, device="cpu") == len(data)
    assert (tmp_path / "out.raw").read_bytes() == data
    assert {name for name, _ in taken} >= {"api.rows", "api.d2h", "filecodec.out"}
    for name, nbytes in taken:
        assert name in PER_BLOCK and nbytes <= window_blocks * PER_BLOCK[name], (name, nbytes)
