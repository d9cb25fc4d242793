"""K5/K6 (tape decoder): the port's plain versions against the JAX package
(snappytpu.kernels.decode_tape, Pallas in interpret mode), on the families of
tests/test_decode_tape.py and the tape fuzz differentials of
tests/test_fuzz_decode.py.  Both packages build their tapes with the same
native builder, so tapes, flags and rows must be equal exactly: flags
everywhere, rows wherever ok.
"""

import numpy as np
import pytest
import torch

from snappytpu import cpu
from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.format.varint import decode_varint
from snappytpu.kernels import decode_tape as jax_tape
from snappytpu.kernels.decode_vm import decode_blocks_vm as jax_decode_vm
from snappytpu.kernels.encode_v2 import encode_blocks_v2 as jax_encode
from snappytpu.model import compress as model_compress
from snappytpu.model.decode import CorruptError, decode_ops
from snappytpu.stream import framing
from snappytpu_torch.kernels import decode_tape, decode_vm4

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

PAD_OUT, BS = C.MAX_COMPRESSED_BLOCK_SIZE, C.MAX_BLOCK_SIZE
CASES = dict(corpus.edge_case_corpus())
CASES["mixed100k"] = corpus.mixed(100_000, seed=7)


@pytest.fixture(autouse=True)
def _native():
    if not cpu.available:
        pytest.skip("the tape builder needs the native runtime")


def _encode(data: bytes, dense: bool = True):
    blocks, lens = framing.pack_blocks(np.frombuffer(data, np.uint8))
    comp, totals = map(np.array, jax_encode(blocks, lens, dense))  # writable copies
    return comp, totals.astype(np.int32), np.asarray(lens, np.int32)


def _port(comp, comp_lens, out_lens):
    out, ok = decode_tape.decode_blocks_tape(comp, comp_lens, out_lens, device="cpu")
    return out.numpy(), ok.numpy()


def _assert_equal_to_jax(comp, comp_lens, out_lens):
    out, ok = _port(comp, comp_lens, out_lens)
    jout, jok = map(np.asarray, jax_tape.decode_blocks_tape(comp, comp_lens, out_lens))
    np.testing.assert_array_equal(ok, jok, err_msg="ok flags")
    np.testing.assert_array_equal(out[ok], jout[ok], err_msg="rows where ok")
    return out, ok


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fast"])
@pytest.mark.parametrize("name", ["alice_like_text", "low_entropy_runs", "32k_random", "mixed100k",
                                  "block_boundary_64k_plus_1"])
def test_own_streams_equal_jax(name, dense):
    data = CASES[name]
    comp, totals, lens = _encode(data, dense)
    out, ok = _assert_equal_to_jax(comp, totals, lens)
    assert ok.all()
    assert b"".join(out[i, : lens[i]].tobytes() for i in range(len(lens))) == data


def test_native_compressor_streams_equal_jax():
    data = corpus.mixed(3 * BS + 99, seed=21)
    stream = np.frombuffer(cpu.compress(data), np.uint8)
    out_len, start = decode_varint(stream)
    offs, out_lens = cpu.scan_ops(stream[start:], out_len)
    rows, comp_lens = cpu.split_rows(stream[start:], offs, PAD_OUT)
    out, ok = _assert_equal_to_jax(rows, comp_lens, out_lens.astype(np.int32))
    assert ok.all()
    assert b"".join(out[i, : out_lens[i]].tobytes() for i in range(len(out_lens))) == data


def test_flips_equal_jax_and_the_block_decoder():
    comp, totals, lens = _encode(corpus.mixed(2 * BS, seed=5))
    rng = np.random.default_rng(0)
    rejected = 0
    for _ in range(12):
        cc = comp.copy()
        i = int(rng.integers(0, comp.shape[0]))
        cc[i, int(rng.integers(0, max(int(totals[i]), 1)))] ^= int(rng.integers(1, 256))
        out, ok = _assert_equal_to_jax(cc, totals, lens)
        vout, vok = map(np.asarray, jax_decode_vm(cc, totals, lens))
        np.testing.assert_array_equal(ok, vok, err_msg="accept set vs the block decoder")
        np.testing.assert_array_equal(out[ok], vout[ok])
        rejected += int(not ok.all())
    assert rejected > 0


def test_overflow_block_falls_back_to_the_block_decoder(monkeypatch):
    """An all-1-byte-literal block needs ~24k records, over TAPE_MAX: the
    builder says -9 and the port decodes the block with K2's route."""
    n = 24_000
    raw = corpus.mixed(n, seed=33)
    ops = bytes(b for x in raw for b in (0x00, x))
    rows = np.zeros((2, PAD_OUT), np.uint8)
    rows[0, : len(ops)] = np.frombuffer(ops, np.uint8)
    comp_lens = np.array([len(ops), 0], np.int32)
    out_lens = np.array([n, 0], np.int32)
    _, nrecs = decode_tape.build_tapes(rows, comp_lens, out_lens)
    assert nrecs.tolist() == [-9, 0]
    calls = []
    real = decode_tape.decode_blocks_vm
    monkeypatch.setattr(decode_tape, "decode_blocks_vm", lambda *a: calls.append(a[0].shape[0]) or real(*a))
    out, ok = _assert_equal_to_jax(rows, comp_lens, out_lens)
    assert calls == [1] and ok.all()
    assert out[0, :n].tobytes() == raw


def test_zero_length_pad_blocks_ok():
    rows = np.zeros((3, PAD_OUT), np.uint8)
    out, ok = _assert_equal_to_jax(rows, np.zeros(3, np.int32), np.zeros(3, np.int32))
    assert ok.all() and not out.any()


def _tape_batch():
    """Builder tapes of both profiles' streams, two malformed rows (-10: a
    comp_len one short, an out_len 7 long) and a pad."""
    comp, totals, lens = _encode(corpus.mixed(3 * BS, seed=13))
    fcomp, ftotals, flens = _encode(corpus.text(BS, seed=14), dense=False)
    rows = np.concatenate([comp, fcomp, comp[:2], np.zeros((1, PAD_OUT), np.uint8)])
    cl = np.concatenate([totals, ftotals, [totals[0] - 1, totals[1]], [0]]).astype(np.int32)
    ol = np.concatenate([lens, flens, [lens[0], lens[1] + 7], [0]]).astype(np.int32)
    tapes, nrecs = decode_tape.build_tapes(rows, cl, ol)
    assert (nrecs == -10).any() and (nrecs > 0).any()
    return rows, tapes, nrecs


def test_plain_run_tape_equals_jax():
    rows, tapes, nrecs = _tape_batch()
    out, ok = decode_tape._run_tape(torch.from_numpy(tapes), torch.from_numpy(nrecs), torch.from_numpy(rows))
    jout, jok = map(np.asarray, jax_tape._run_tape(tapes, nrecs, rows))
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(ok.numpy(), nrecs >= 0)
    np.testing.assert_array_equal(out.numpy()[jok], jout[jok])


def test_staged_tapes_cut_to_the_longest_give_the_same_rows():
    rows, tapes, nrecs = _tape_batch()
    tp, nr, rw = decode_tape.stage(rows, tapes, nrecs, device="cpu")
    assert tp.shape[1] == 2 * int(nrecs.max()) < tapes.shape[1]
    full = decode_tape._run_tape(torch.from_numpy(tapes), torch.from_numpy(nrecs), torch.from_numpy(rows))
    cut = decode_tape._run_tape(tp, nr, rw)
    assert torch.equal(full[0], cut[0]) and torch.equal(full[1], cut[1])


@pytest.mark.parametrize("K", [2, 4])
def test_run_tape_k_equals_jax_and_run_tape(K):
    rows, tapes, nrecs = _tape_batch()
    B = rows.shape[0] // K * K
    rows, tapes, nrecs = rows[:B], tapes[:B], nrecs[:B]
    args = (torch.from_numpy(tapes), torch.from_numpy(nrecs), torch.from_numpy(rows))
    out, ok = decode_tape._run_tape_k(*args, K=K)
    flat_out, flat_ok = decode_tape._run_tape(*args)
    assert torch.equal(out, flat_out) and torch.equal(ok, flat_ok)
    jout, jok = map(np.asarray, jax_tape._run_tape_k(tapes, nrecs, rows, K=K))
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(out.numpy()[jok], jout[jok])


def test_run_tape_k_rejects_a_ragged_batch():
    z = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of K"):
        decode_tape._run_tape_k(torch.zeros((3, 2), dtype=torch.int32), z, torch.zeros((3, PAD_OUT), dtype=torch.uint8), K=2)


def _record(src, dst, ln, pk2=0):
    return [src | (pk2 << 18) | (ln << 20), dst]


@pytest.mark.parametrize("record, good", [
    (_record(512, decode_tape.OUT_BASE, 8), True),                           # literal bytes
    (_record(0, decode_tape.OUT_BASE + 8, 16, pk2=3), True),                  # period-4 fill
    (_record(512, decode_tape.OUT_BASE, 505), False),                         # longer than a piece
    (_record(512, decode_tape.IMAGE_BYTES - 4, 8), False),                    # writes past the image
    (_record(decode_tape.IMAGE_BYTES - 4, decode_tape.OUT_BASE, 8), False),   # reads past the image
    (_record(0, 2, 8, pk2=3), False),                                         # fill before the image
    ([512 | (8 << 20), -1], False),                                           # negative destination
    (_record(decode_tape.OUT_BASE, decode_tape.OUT_BASE + 4, 8), False),      # overlapping copy
    (_record(decode_tape.OUT_BASE, decode_tape.OUT_BASE + 8, 8), True),       # adjacent copy
], ids=["copy", "fill", "long", "dst-past", "src-past", "fill-before", "dst-negative", "overlap", "adjacent"])
def test_records_outside_the_image_are_not_ok(record, good):
    rows = torch.from_numpy(np.arange(PAD_OUT, dtype=np.uint8).reshape(1, PAD_OUT).copy())
    head = _record(512, decode_tape.OUT_BASE, 12)
    tapes = torch.tensor([head + record], dtype=torch.int32)
    out, ok = decode_tape._run_tape(tapes, torch.tensor([2], dtype=torch.int32), rows)
    assert bool(ok[0]) is good
    assert out[0, :8].tolist() == list(range(8))  # the first record ran either way
    if good and record[0] >> 18 & 3:
        assert out[0, 8:24].tolist() == [4, 5, 6, 7] * 4


def test_nrecs_beyond_the_tape_is_not_ok():
    rows = torch.zeros((1, PAD_OUT), dtype=torch.uint8)
    _, ok = decode_tape._run_tape(torch.zeros((1, 4), dtype=torch.int32), torch.tensor([3], dtype=torch.int32), rows)
    assert not ok[0]


def _tape_result(ops: np.ndarray, out_len: int):
    if out_len > BS or ops.size > PAD_OUT:
        return None
    rows = np.zeros((1, PAD_OUT), np.uint8)
    rows[0, : ops.size] = ops
    out, ok = _port(rows, np.array([ops.size], np.int32), np.array([out_len], np.int32))
    return ("ok", out[0, :out_len].tobytes()) if ok[0] else ("reject", None)


def _model_result(ops: np.ndarray, out_len: int):
    try:
        return ("ok", decode_ops(ops, out_len).tobytes())
    except (CorruptError, ValueError):
        return ("reject", None)


@pytest.mark.parametrize("seed", range(8))
def test_tape_mutation_differential(seed):
    rng = np.random.default_rng(7000 + seed)
    data = corpus.mixed(int(rng.integers(500, 60000)), seed=seed)
    arr = np.frombuffer(model_compress(data), np.uint8).copy()
    out_len, start = framing.read_preamble(arr)
    arr[int(rng.integers(start, arr.size))] ^= int(rng.integers(1, 256))
    t = _tape_result(arr[start:], out_len)
    if t is not None:
        assert t == _model_result(arr[start:], out_len)


@pytest.mark.parametrize("seed", range(8))
def test_tape_garbage_ops(seed):
    rng = np.random.default_rng(8000 + seed)
    ops = rng.integers(0, 256, int(rng.integers(2, 2000)), dtype=np.uint8)
    out_len = int(rng.integers(1, 65536))
    t = _tape_result(ops, out_len)
    if t is not None:
        assert t == _model_result(ops, out_len)


def test_block_decoder_route_equals_tape_route():
    """K2's plain version on the same rows (the route without the native
    runtime) gives the tape route's flags and rows, valid and flipped."""
    comp, totals, lens = _encode(corpus.mixed(3 * BS, seed=13))
    comp[1, 9] ^= 0x77
    out, ok = _port(comp, totals, lens)
    vout, vok = decode_vm4.decode_blocks_vm4(torch.from_numpy(comp), torch.from_numpy(totals), torch.from_numpy(lens))
    np.testing.assert_array_equal(ok, vok.numpy())
    np.testing.assert_array_equal(out[ok], vout.numpy()[ok])
    assert ok[0] and ok[2]
