"""Which decoder parses a host stream's blocks in `api.decompress`.

On the CPU: the route rule, `api.parses_on_card`, by device.  On a card
(marked `cuda`, skipped without one): a 1 MiB page, the 10 MB sample and a
stream whose last block overflows the tape's record cap decode on
the card with K2 parsing every block-route call (`decompress.k2_calls` ==
`decompress.device_calls`), no tape decoder launched, and the same bytes as
on the CPU device, where the tape route runs; the file codec's windows
take that route too.  Run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_decode_card.py -q`
(this file imports neither JAX nor the JAX package)."""

import functools

import numpy as np
import pytest
import torch

from benchmark import datagen
from snappytpu_torch import api, cpu, profiling
from snappytpu_torch.format import constants as C
from snappytpu_torch.format.varint import encode_varint
from snappytpu_torch.stream import filecodec, framing

BS = C.MAX_BLOCK_SIZE

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side


@pytest.mark.parametrize("device, on_card", [
    ("cpu", False), (torch.device("cpu"), False), ("cuda", True), ("cuda:1", True), (torch.device("cuda", 0), True),
])
def test_the_card_parses_on_a_cuda_device_only(device, on_card):
    assert api.parses_on_card(device) is on_card


# ---- on a card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if not cpu.available:
        pytest.skip("the CPU device's tape route needs the port's native runtime")
    return torch.device("cuda", torch.cuda.current_device())


@functools.cache
def rdg(n: int, seed: int) -> bytes:
    """n bytes of zstd's synthetic sample at compressibility 50 %, as the benchmark's objects."""
    return datagen.rdg(n, datagen._generator(seed, "cpu"), "cpu").numpy().tobytes()


def overflowing(device) -> tuple[bytes, bytes]:
    """(data, stream): one block of a page's stream, then 24,000 one-byte
    literals, more records than a tape's cap (TAPE_MAX), which K5's route
    hands to K2."""
    head, tail = np.frombuffer(api.compress(rdg(BS, 5), "fast", device=device), np.uint8), rdg(24_000, 6)
    ops = head[framing.read_preamble(head)[1]:].tobytes()
    return rdg(BS, 5) + tail, encode_varint(BS + len(tail)) + ops + b"".join(bytes([0, x]) for x in tail)


def sample(n: int, seed: int):
    return lambda device: (rdg(n, seed), api.compress(rdg(n, seed), "fast", device=device))


STREAMS = {"page_1MiB": sample(1 << 20, 1), "sample_10MB": sample(10_000_000, 2), "tape_overflow": overflowing}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k2_parses_every_block_route_call_on_the_card(card, name):
    data, stream = STREAMS[name](card)
    want = api.decompress(stream, device="cpu")
    profiling.reset_counters()
    got = api.decompress(stream, device=card)
    counts = profiling.counters()
    assert got == want == data
    calls = -(-len(data) // (BS * api.DEVICE_BATCH))
    assert counts["decompress.k2_calls"] == counts["decompress.device_calls"] == calls
    assert "decode_tape.launches" not in counts and "decompress.reroutes" not in counts


@pytest.mark.cuda
def test_decompress_file_parses_every_window_with_k2_on_the_card(card, tmp_path):
    """The 10 MB sample's 153 blocks in windows of 64: three block-route
    calls, each parsed by K2, and the file holds api.decompress's bytes."""
    data, stream = STREAMS["sample_10MB"](card)
    comp, out = tmp_path / "c.snappy", tmp_path / "out.raw"
    comp.write_bytes(stream)
    want = api.decompress(stream, device=card)
    profiling.reset_counters()
    assert filecodec.decompress_file(comp, out, window_blocks=64, device=card) == len(data)
    counts = profiling.counters()
    assert out.read_bytes() == want == data
    assert counts["decompress.k2_calls"] == counts["decompress.device_calls"] == 3
    assert "decode_tape.launches" not in counts and "decompress.reroutes" not in counts
