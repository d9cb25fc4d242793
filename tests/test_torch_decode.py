"""K2 (block decoder): the port's plain version against the JAX decoder
(snappytpu.kernels.decode_vm.decode_blocks_vm, Pallas in interpret mode).

Four families of (B, 73728) rows: the JAX encoder's own streams, the
google/snappy golden streams cut into blocks, zero-length pad blocks, and a
seeded fuzz set (mutations, truncations, garbage ops and one stream per
reject rule).  The ok flags must be equal everywhere and the rows equal
wherever ok.  tests/test_torch_decode_host.py reuses these rows.
"""

import functools
import glob
import os

import numpy as np
import pytest
import torch

from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.kernels.decode_vm import decode_blocks_vm as jax_decode
from snappytpu.kernels.encode_v2 import encode_blocks_v2 as jax_encode
from snappytpu.stream import framing
from snappytpu_torch.kernels import decode_vm, decode_vm4

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

PAD_OUT, BS = C.MAX_COMPRESSED_BLOCK_SIZE, C.MAX_BLOCK_SIZE
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _rows(streams):
    """[(ops bytes, out_len)] -> (rows, comp_lens, out_lens) numpy arrays."""
    rows = np.zeros((len(streams), PAD_OUT), np.uint8)
    for i, (ops, _) in enumerate(streams):
        rows[i, : len(ops)] = np.frombuffer(ops, np.uint8)
    return (rows, np.array([len(o) for o, _ in streams], np.int32),
            np.array([n for _, n in streams], np.int32))


@functools.cache
def own_streams():
    """The JAX encoder's blocks, both profiles."""
    data = [corpus.text(BS, seed=21), corpus.low_entropy(BS, seed=22), corpus.random_bytes(BS, seed=23),
            corpus.structured_binary(BS, seed=24), corpus.mixed(BS, seed=25), corpus.text(3001, seed=26)]
    blocks = np.zeros((len(data), BS), np.uint8)
    lens = np.array([len(d) for d in data], np.int32)
    for i, d in enumerate(data):
        blocks[i, : len(d)] = np.frombuffer(d, np.uint8)
    out = []
    for dense in (True, False):
        comp, totals = jax_encode(blocks, lens, dense)
        comp, totals = np.asarray(comp), np.asarray(totals)
        out += [(comp[i, : totals[i]].tobytes(), int(lens[i])) for i in range(len(data))]
    return out


@functools.cache
def golden_streams():
    out = []
    for path in sorted(glob.glob(os.path.join(GOLDEN, "*.snappy"))):
        arr = np.fromfile(path, np.uint8)
        n, start = framing.read_preamble(arr)
        chunks, olens = framing.split_ops_stream(arr[start:], n)
        out += [(c.tobytes(), int(o)) for c, o in zip(chunks, olens)]
    return out


def _lit(payload: bytes) -> bytes:
    n = len(payload) - 1
    if n < 60:
        return bytes([n << 2]) + payload
    nb = (n.bit_length() + 7) // 8
    return bytes([(59 + nb) << 2]) + n.to_bytes(nb, "little") + payload


_LIT = _lit(b"abcd")
RULES = [  # (ops, out_len, ok): one stream per accept-set rule and its valid twin
    (_LIT + bytes([(3 << 2) | 3, 4, 0, 0, 0]), 8, True),      # COPY4, 4th offset byte 0
    (_LIT + bytes([(3 << 2) | 3, 4, 0, 0, 1]), 8, False),     # COPY4, 4th offset byte set
    (bytes([63 << 2, 3, 0, 0, 0]) + b"wxyz", 4, True),        # 4-byte-length literal
    (bytes([63 << 2, 3, 0, 0, 0x40]) + b"wxyz", 4, False),    # ... with b4 & 0xC0
    (bytes([62 << 2, 99, 0, 0]) + bytes(100), 100, True),     # 3-byte-length literal
    (bytes([61 << 2, 0x2B, 1]) + bytes(300), 300, True),      # 2-byte-length literal
    (_LIT + bytes([(0 << 2) | 1, 0]), 8, False),              # COPY1 dist 0
    (_LIT + bytes([(0 << 2) | 1, 4]), 8, True),               # COPY1 dist == opc
    (_LIT + bytes([(3 << 2) | 2, 5, 0]), 8, False),           # COPY2 dist > opc
    (_LIT + bytes([(63 << 2) | 2, 1, 0]), 68, True),          # dist 1 run of 64
    (_LIT + bytes([(63 << 2) | 2, 3, 0]), 68, True),          # dist 3 overlap
    (_lit(bytes(range(40))) + bytes([(15 << 2) | 1, 7]), 51, False),  # COPY1 offset bit 8: dist 263
    (_lit(bytes(10)), 10, True),                              # one literal, exact
    (_lit(bytes(10))[:-1], 10, False),                        # literal past comp_len
    (_LIT + bytes([(3 << 2) | 2, 4]), 8, False),              # header past comp_len
    (_LIT + b"\x00", 4, False),                               # trailing byte
    (_LIT, 5, False),                                         # output short
    (_LIT + bytes([(3 << 2) | 2, 4, 0]), 6, False),           # op past out_len
    (b"", 0, True), (b"", 5, False), (b"\x00", 0, False),      # empty
]


def rule_streams():
    return [(ops, n) for ops, n, _ in RULES]


@functools.cache
def fuzz_streams():
    rng = np.random.default_rng(77)
    base = own_streams() + golden_streams()
    out = list(rule_streams())
    for k in range(24):  # byte mutations
        ops, n = base[int(rng.integers(0, len(base)))]
        arr = bytearray(ops)
        for _ in range(1 + k % 3):
            arr[int(rng.integers(0, len(arr)))] ^= int(rng.integers(1, 256))
        out.append((bytes(arr), n))
    for k in range(8):  # truncations
        ops, n = base[int(rng.integers(0, len(base)))]
        out.append((ops[: int(len(ops) * rng.uniform(0.1, 0.99))], n))
    for k in range(12):  # garbage ops
        ops = rng.integers(0, 256, int(rng.integers(2, 2000)), dtype=np.uint8).tobytes()
        out.append((ops, int(rng.integers(1, BS + 1))))
    return out


FAMILIES = {
    "own": own_streams,
    "golden": golden_streams,
    "pads": lambda: [(b"", 0)] * 3,
    "fuzz": fuzz_streams,
}


@functools.cache
def decoded(family):
    """(rows, comp_lens, out_lens, jax out, jax ok) for one family."""
    rows, cl, ol = _rows(FAMILIES[family]())
    out, ok = jax_decode(rows, cl, ol)
    return rows, cl, ol, np.asarray(out), np.asarray(ok)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_decoder_equals_jax(family):
    rows, cl, ol, jout, jok = decoded(family)
    out, ok = decode_vm.decode_blocks_vm(torch.from_numpy(rows), torch.from_numpy(cl), torch.from_numpy(ol))
    assert out.dtype == torch.uint8 and tuple(out.shape) == (rows.shape[0], BS) and ok.dtype == torch.bool
    np.testing.assert_array_equal(ok.numpy(), jok, err_msg="ok flags")
    np.testing.assert_array_equal(out.numpy()[jok], jout[jok], err_msg="rows where ok")
    if family != "fuzz":
        assert jok.all()
    else:
        assert 0 < jok.sum() < jok.size  # the fuzz set holds both verdicts


def test_rule_verdicts():
    rows, cl, ol = _rows(rule_streams())
    _, ok = decode_vm4.decode_blocks_vm4(torch.from_numpy(rows), torch.from_numpy(cl), torch.from_numpy(ol))
    assert ok.tolist() == [want for _, _, want in RULES]


def test_ok_rows_are_zero_past_out_len():
    rows, cl, ol, _, _ = decoded("own")
    out, ok = decode_vm4.decode_blocks_vm4(torch.from_numpy(rows), torch.from_numpy(cl), torch.from_numpy(ol))
    assert bool(ok.all())
    for i, n in enumerate(ol):
        assert not out[i, n:].any()


def test_rejects_wrong_shapes():
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        decode_vm4.decode_blocks_vm4(torch.zeros((1, 100), dtype=torch.uint8), z, z)
    with pytest.raises(ValueError):
        decode_vm4.decode_blocks_vm4(torch.zeros((1, PAD_OUT), dtype=torch.uint8), z, torch.zeros(2, dtype=torch.int32))


def test_lengths_outside_the_row_are_not_ok():
    rows = torch.zeros((3, PAD_OUT), dtype=torch.uint8)
    _, ok = decode_vm4.decode_blocks_vm4(
        rows, torch.tensor([PAD_OUT + 1, 0, -1], dtype=torch.int32), torch.tensor([0, BS + 1, 0], dtype=torch.int32)
    )
    assert not ok.any()


@functools.cache
def _vm2_family(name):
    """The rows of tests/test_decode_vm.py's A/B matrix: the JAX encoder's
    stream of corpus.mixed(100_000, seed=7), as is, with one flipped byte,
    or with the second block's comp_len one short (malformed)."""
    blocks, lens = framing.pack_blocks(np.frombuffer(corpus.mixed(100_000, seed=7), np.uint8))
    comp, totals = map(np.array, jax_encode(blocks, lens))
    totals = totals.astype(np.int32)
    if name == "flipped":
        comp[0, 3] ^= 0xFF
    if name == "short":
        totals[1] -= 1
    return comp, totals, np.asarray(lens, np.int32)


@pytest.mark.parametrize("name", ["valid", "flipped", "short"])
def test_vm2_entry_equals_vm4_and_jax_vm2(name):
    """K3: decode_blocks_vm2 equals decode_blocks_vm4 and the JAX package's
    decode_blocks_vm2 (Pallas in interpret mode)."""
    from snappytpu.kernels.decode_vm2 import decode_blocks_vm2 as jax_vm2
    from snappytpu_torch.kernels import decode_vm2

    rows, cl, ol = _vm2_family(name)
    args = (torch.from_numpy(rows), torch.from_numpy(cl), torch.from_numpy(ol))
    out, ok = decode_vm2.decode_blocks_vm2(*args)
    out4, ok4 = decode_vm4.decode_blocks_vm4(*args)
    assert torch.equal(out, out4) and torch.equal(ok, ok4)
    jout, jok = map(np.asarray, jax_vm2(rows, cl, ol))
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(out.numpy()[jok], jout[jok])
    assert jok.tolist() == {"valid": [True, True], "flipped": jok.tolist(), "short": [True, False]}[name]
