"""The decode route's reused host buffers (snappytpu_torch/hostbuf.py) and
the native runtime's `out=` forms that write into them: a buffer is kept a
name and a thread and only grows, a request above KEEP_BYTES is fresh, and
calls into kept buffers give what calls into fresh arrays give."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from snappytpu.bench import corpus
from snappytpu_torch import api, cpu, hostbuf
from snappytpu_torch.format import constants as C
from snappytpu_torch.kernels import decode_tape
from snappytpu_torch.stream import framing

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

STRIDE = C.MAX_COMPRESSED_BLOCK_SIZE


def native():
    if not cpu.available:
        pytest.skip("the port's native runtime is not built here")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.bool])
def test_a_buffer_is_kept_and_only_grows(dtype):
    a = hostbuf.take("test.grow", (4, 64), dtype)
    assert a.shape == (4, 64) and a.dtype == dtype and a.is_contiguous()
    assert hostbuf.take("test.grow", (2, 64), dtype).data_ptr() == a.data_ptr()  # smaller: the same memory
    assert hostbuf.take("test.grow", (4, 64), dtype).data_ptr() == a.data_ptr()
    b = hostbuf.take("test.grow", (4, 64 * 1024), dtype)  # larger: grown
    assert b.shape == (4, 64 * 1024)
    assert hostbuf.take("test.grow", (4, 64), dtype).data_ptr() == b.data_ptr()


def test_names_do_not_share_memory():
    a = hostbuf.take("test.a", (1000,), torch.uint8)
    b = hostbuf.take("test.b", (1000,), torch.uint8)
    a.fill_(1)
    b.fill_(2)
    assert int(a.sum()) == 1000 and int(b.sum()) == 2000


def test_above_keep_bytes_a_buffer_is_fresh(monkeypatch):
    monkeypatch.setattr(hostbuf, "KEEP_BYTES", 4096)
    kept = hostbuf.take("test.keep", (4096,), torch.uint8)
    assert hostbuf.take("test.keep", (4096,), torch.uint8).data_ptr() == kept.data_ptr()
    big = [hostbuf.take("test.keep", (4097,), torch.uint8) for _ in range(2)]
    assert big[0].shape == (4097,) and not big[0].is_pinned()
    assert len({t.data_ptr() for t in big} | {kept.data_ptr()}) == 3
    assert hostbuf.take("test.keep", (100,), torch.uint8).data_ptr() == kept.data_ptr()


def test_each_thread_has_its_own():
    here = hostbuf.take("test.thread", (512,), torch.uint8).data_ptr()
    there = []
    t = threading.Thread(target=lambda: there.append(hostbuf.take("test.thread", (512,), torch.uint8).data_ptr()))
    t.start()
    t.join()
    assert there and there[0] != here


@pytest.mark.parametrize("device,pinned", [("cpu", False), ("cuda", True), ("cuda:1", True)])
def test_pinned_for_a_cuda_device_only(device, pinned):
    assert hostbuf.pinned_for(device) is pinned


def _rows_of(n: int, seed: int):
    data = corpus.mixed(n, seed=seed)
    stream = np.frombuffer(cpu.compress(data), np.uint8)
    _, start = framing.read_preamble(stream)
    ops = stream[start:]
    offs, lens = cpu.scan_ops(ops, n)
    return ops, offs, lens.astype(np.int32), data


@pytest.mark.parametrize("n", [1, 65536, 3 * 65536 + 17])
def test_out_forms_equal_fresh_arrays(n):
    """split_rows, build_tapes and compact_into writing into dirty kept
    buffers give what split_rows, build_tapes and compact give."""
    native()
    ops, offs, lens, data = _rows_of(n, seed=n % 97)
    B = offs.size
    rows, cl = cpu.split_rows(ops, offs, STRIDE)
    dirty = [np.full((B, STRIDE), 0xAB, np.uint8), np.full(B, -7, np.int32)]
    assert all(np.array_equal(x, y) for x, y in zip(cpu.split_rows(ops, offs, STRIDE, out=dirty), (rows, cl)))
    tapes, nrecs = decode_tape.build_tapes(rows, cl, lens)
    reused = (np.full(tapes.shape, 0x55, np.int32), np.full(B, -3, np.int32))
    t2, n2 = decode_tape.build_tapes(rows, cl, lens, out=reused)
    assert np.array_equal(n2, nrecs)
    for b in range(B):  # equal as far as each tape's records reach
        assert np.array_equal(t2[b, : 2 * nrecs[b]], tapes[b, : 2 * nrecs[b]])
    out = np.full(n + 10, 0xCD, np.uint8)
    decoded = np.zeros((B, C.MAX_BLOCK_SIZE), np.uint8)
    for b in range(B):
        start = b * C.MAX_BLOCK_SIZE
        decoded[b, : lens[b]] = np.frombuffer(data[start : start + lens[b]], np.uint8)
    assert cpu.compact_into(decoded, lens, out) == n
    assert out[:n].tobytes() == data == cpu.compact(decoded, lens)
    assert (out[n:] == 0xCD).all()


@pytest.mark.parametrize("which", ["split_rows", "build_tapes", "compact_into"])
def test_out_of_the_wrong_shape_or_size_is_refused(which):
    native()
    ops, offs, lens, _ = _rows_of(2 * 65536, seed=5)
    rows, cl = cpu.split_rows(ops, offs, STRIDE)
    with pytest.raises(ValueError if which != "compact_into" else cpu.NativeError):
        if which == "split_rows":
            cpu.split_rows(ops, offs, STRIDE, out=(np.empty((1, STRIDE), np.uint8), np.empty(1, np.int32)))
        elif which == "build_tapes":
            decode_tape.build_tapes(rows, cl, lens, out=(np.empty((2, 8), np.int32), np.empty(2, np.int32)))
        else:
            cpu.compact_into(np.zeros((2, C.MAX_BLOCK_SIZE), np.uint8), lens, np.empty(100, np.uint8))


def test_calls_of_other_sizes_in_turn_decode_alike():
    """Streams larger, smaller and larger again through the same kept
    buffers: each call's answer is its own, and an earlier answer stays."""
    sizes = [3 * 65536 + 5, 1000, 70_000, 5 * 65536, 17]
    data = [corpus.mixed(n, seed=40 + i) for i, n in enumerate(sizes)]
    streams = [api.compress(d, "fast", device="cpu") for d in data]
    answers = [api.decompress(s, device="cpu") for s in streams + streams[::-1]]
    assert answers == data + data[::-1]


def test_threads_decoding_at_once_keep_their_answers_apart():
    """More threads than cores, each decoding its own streams in turn with a
    short switch interval: every answer is its own stream's, as it would
    not be if two threads wrote one buffer."""
    sizes = [65536 + 7 * i for i in range(12)]
    data = [corpus.mixed(n, seed=60 + i) for i, n in enumerate(sizes)]
    streams = [api.compress(d, "fast", device="cpu") for d in data]
    wrong, done = [], []

    def work(k):
        for r in range(3):
            i = (k + r) % len(streams)
            if api.decompress(streams[i], device="cpu") != data[i]:
                wrong.append((k, i))
        done.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(len(threads))) and not wrong
