"""K4 (windowed stream decoder) and api._decompress_windowed: the port's
plain versions against the JAX package (snappytpu.kernels.decode_vm2.
decode_stream_vm, Pallas in interpret mode) on the streams of
tests/test_stream_decode.py and the windowed differentials of
tests/test_fuzz_decode.py.  Flags are compared everywhere; rows where the
chunk and every chunk before it are ok.
"""

import numpy as np
import pytest
import torch

from snappytpu import api as jax_api
from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.format.varint import encode_varint
from snappytpu.kernels.decode_vm2 import decode_stream_vm as jax_stream
from snappytpu.model import compress as model_compress
from snappytpu.model.decode import CorruptError, decode_ops
from snappytpu.stream import framing
from snappytpu_torch import api
from snappytpu_torch.kernels import decode_vm2
from test_fuzz_decode import _unaligned_stream
from test_stream_decode import _build_straddling_stream, _copy2, _copy4, _lit

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

BS = C.MAX_BLOCK_SIZE


def _both(padded, comp_lens, out_lens, ctx_lens, ctx0):
    """(port out, port ok, jax out, jax ok) as numpy."""
    out, ok = decode_vm2.decode_stream_vm(
        torch.from_numpy(padded), torch.from_numpy(comp_lens), torch.tensor(out_lens, dtype=torch.int32),
        torch.tensor(ctx_lens, dtype=torch.int32), torch.from_numpy(ctx0))
    jout, jok = map(np.asarray, jax_stream(padded, comp_lens, np.asarray(out_lens, np.int32),
                                           np.asarray(ctx_lens, np.int32), ctx0))
    return out.numpy(), ok.numpy(), jout, jok


def _assert_agree(padded, comp_lens, out_lens, ctx_lens, ctx0):
    out, ok, jout, jok = _both(padded, comp_lens, out_lens, ctx_lens, ctx0)
    np.testing.assert_array_equal(ok, jok, err_msg="ok flags")
    prefix = np.cumprod(ok).astype(bool)
    np.testing.assert_array_equal(out[prefix], jout[prefix], err_msg="rows of ok prefix")
    return out, ok


def _ops(stream: bytes):
    arr = np.frombuffer(stream, np.uint8)
    n, start = framing.read_preamble(arr)
    return arr[start:], n


def _joined(out, out_lens):
    return b"".join(out[i, : out_lens[i]].tobytes() for i in range(len(out_lens)))


@pytest.mark.parametrize("seed", [0, 1])
def test_straddling_stream_equals_jax(seed):
    stream, data = _build_straddling_stream(seed)
    chunks, out_lens, ctx_lens = framing.split_ops_windowed(*_ops(stream))
    assert len(chunks) > 1
    padded, comp_lens = framing.pad_chunks(chunks)
    out, ok = _assert_agree(padded, comp_lens, out_lens, ctx_lens, np.zeros(BS, np.uint8))
    assert ok.all()
    assert _joined(out, out_lens) == data
    assert all(not out[i, n:].any() for i, n in enumerate(out_lens))


def test_nonzero_ctx0_equals_jax():
    """Start a straddling stream at its second chunk, with the output before
    it as ctx0 (what _decompress_windowed carries between calls)."""
    stream, data = _build_straddling_stream(2)
    chunks, out_lens, ctx_lens = framing.split_ops_windowed(*_ops(stream))
    done = out_lens[0]
    ctx0 = np.zeros(BS, np.uint8)
    tail = np.frombuffer(data[max(done - BS, 0) : done], np.uint8)
    ctx0[BS - tail.size :] = tail
    padded, comp_lens = framing.pad_chunks(chunks[1:])
    out, ok = _assert_agree(padded, comp_lens, out_lens[1:], ctx_lens[1:], ctx0)
    assert ok.all()
    assert _joined(out, out_lens[1:]) == data[done:]


def test_copies_into_a_random_ctx0_equal_jax():
    """Chunk 0 with a full 64 KiB context of random bytes: copies reach into
    it, one to its very first byte; the same chunk with ctx_len 65535 is bad."""
    ctx0 = np.random.default_rng(5).integers(0, 256, BS, dtype=np.uint8)
    copies = [(64, 3 + 1000), (9, 40_000), (5, 3 + 64 + 9 + BS)]  # (len, dist); the last reaches ctx0[0]
    ops = _lit(b"xyz") + _copy2(*copies[0]) + _copy2(*copies[1]) + _copy4(*copies[2])
    want = bytearray(ctx0.tobytes()) + b"xyz"
    for ln, dist in copies:
        for _ in range(ln):
            want.append(want[-dist])
    padded, comp_lens = framing.pad_chunks([np.frombuffer(ops, np.uint8)] * 2)
    n = len(want) - BS
    out, ok = _assert_agree(padded, comp_lens, [n, n], [BS, BS - 1], ctx0)
    assert ok.tolist() == [True, False]
    assert out[0, :n].tobytes() == bytes(want[BS:])


def test_forward_reference_is_rejected():
    payload = bytes(range(256)) * 300  # 76800 bytes -> 2 chunks
    stream = encode_varint(len(payload) + 8) + _lit(payload[:50000]) + _lit(payload[50000:]) + _copy4(8, 60000 + 16801)
    chunks, out_lens, ctx_lens = framing.split_ops_windowed(*_ops(stream))
    padded, comp_lens = framing.pad_chunks(chunks)
    _, ok = _assert_agree(padded, comp_lens, out_lens, ctx_lens, np.zeros(BS, np.uint8))
    assert not ok.all()
    with pytest.raises(ValueError):  # CorruptError or the native NativeError
        api.decompress(stream, device="cpu")


def test_decompress_windowed_carries_context_across_batches(monkeypatch):
    """Batches of 2 chunks with copies reaching across the batch seams, as
    tests/test_stream_decode.py:130-158 drives the JAX package."""
    monkeypatch.setattr(api, "_WINDOWED_BATCH", 2)
    monkeypatch.setattr(jax_api, "_WINDOWED_BATCH", 2)
    base = bytearray(corpus.mixed(150_000, seed=91))
    base[70_000:130_000] = base[5_000:65_000]
    data = bytes(base)
    shift = 23
    tail_ops, _ = _ops(model_compress(data[shift:]))
    ops = np.concatenate([np.frombuffer(bytes([(shift - 1) << 2]) + data[:shift], np.uint8), tail_ops])
    split = framing.split_ops_windowed(ops, len(data))
    assert len(split[0]) >= 3
    calls = []
    real = api.decode_stream_vm
    monkeypatch.setattr(api, "decode_stream_vm", lambda *a: calls.append(a[0].shape[0]) or real(*a))
    got = api._decompress_windowed(split, device="cpu")
    assert got == data == jax_api._decompress_windowed(split)
    assert len(calls) >= 2 and max(calls) == 2


def test_far_reach_copy_falls_back_to_the_host_decoder(monkeypatch):
    lit = np.random.default_rng(61).integers(0, 256, 131_073, dtype=np.uint8)
    ops = b"".join(_lit(seg.tobytes()) for seg in (lit[:60000], lit[60000:120000], lit[120000:]))
    ops += _copy2(64, 61_000)
    expected = np.concatenate([lit, lit[131_073 - 61_000 : 131_073 - 61_000 + 64]]).tobytes()
    stream = encode_varint(131_073 + 64) + ops
    monkeypatch.setattr(api, "host_fallbacks", 0)
    assert api.decompress(stream, device="cpu") == expected == jax_api.decompress(stream)
    # the split starts the last chunk at 120000, so the copy's reach (61000
    # back from 131073) lies inside that chunk's 65536-byte context: the
    # windowed decoder proves it, as in the JAX package, and nothing falls back
    assert api.host_fallbacks == 0


def _windowed_agree(ops: np.ndarray, out_len: int):
    """The windowed pipeline on both packages -> the port's verdict."""
    try:
        chunks, out_lens, ctx_lens = framing.split_ops_windowed(ops, out_len)
    except (CorruptError, ValueError):
        return ("reject", None)
    padded, comp_lens = framing.pad_chunks(chunks)
    out, ok = _assert_agree(padded, comp_lens, out_lens, ctx_lens, np.zeros(BS, np.uint8))
    return ("ok", _joined(out, out_lens)) if ok.all() else ("reject", None)


def _model(ops: np.ndarray, out_len: int):
    try:
        return ("ok", decode_ops(ops, out_len).tobytes())
    except (CorruptError, ValueError):
        return ("reject", None)


@pytest.mark.parametrize("seed", range(12))
def test_windowed_mutation_differential(seed):
    rng = np.random.default_rng(4000 + seed)
    ops, out_len, data = _unaligned_stream(rng, seed)
    assert _windowed_agree(ops, out_len) == ("ok", data)
    for _ in range(3):
        mut = ops.copy()
        for _m in range(int(rng.integers(1, 5))):
            mut[int(rng.integers(0, mut.size))] ^= int(rng.integers(1, 256))
        assert _windowed_agree(mut, out_len) == _model(mut, out_len)


@pytest.mark.parametrize("seed", range(8))
def test_windowed_truncation_differential(seed):
    rng = np.random.default_rng(5000 + seed)
    ops, out_len, _ = _unaligned_stream(rng, seed + 20)
    for frac in (0.25, 0.6, 0.95):
        cut = ops[: int(ops.size * frac)]
        assert _windowed_agree(cut, out_len) == _model(cut, out_len)


def test_rejects_wrong_shapes():
    rows = torch.zeros((2, C.MAX_COMPRESSED_BLOCK_SIZE), dtype=torch.uint8)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="ctx_lens"):
        decode_vm2.decode_stream_vm(rows, z, z, torch.zeros(3, dtype=torch.int32), torch.zeros(BS, dtype=torch.uint8))
    with pytest.raises(ValueError, match="ctx0"):
        decode_vm2.decode_stream_vm(rows, z, z, z, torch.zeros(BS - 1, dtype=torch.uint8))
