"""T2 (decode anatomy probe): the port's plain walk against the JAX package's
tools/dec_anatomy.py, run with Pallas in interpret mode.  Only the tool's
definitions are executed (its source up to `makers = {`, from a string, so
nothing is written under tools/), with `pl` replaced by a namespace whose
pallas_call passes interpret=True.

Inputs: dense-encoded text and mixed blocks made from numpy seeds through
the JAX encoder, mutated copies and a zero-length block.  For every variant
the port's final output cursor equals the JAX tool's ok tile (its final
`opc`); for `full` the port's rows and flags equal
snappytpu.kernels.decode_vm2.decode_blocks_vm2.  Tolerance: exact.
"""

import functools
import os
import types

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.kernels.decode_vm2 import decode_blocks_vm2 as jax_vm2
from snappytpu.kernels.encode_v2 import encode_blocks_v2 as jax_encode
from snappytpu_torch.tools import dec_anatomy as port

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = C.MAX_BLOCK_SIZE


@functools.cache
def _jax_tool():
    path = os.path.join(ROOT, "tools", "dec_anatomy.py")
    with open(path) as f:
        src = f.read()
    ns = {"__file__": path, "__name__": "jax_dec_anatomy"}
    exec(compile(src[: src.index("makers = {")], path, "exec"), ns)
    fake = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    fake.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns["pl"] = fake
    return ns


@functools.cache
def _batch():
    """2 text and 2 mixed blocks (full and partial), 3 mutated copies and a
    zero-length block, dense-encoded by the JAX encoder."""
    samples = [corpus.text(BS, seed=41), corpus.text(20_000, seed=42), corpus.mixed(BS, seed=43),
               corpus.mixed(9_000, seed=44)]
    blocks = np.zeros((len(samples) + 1, BS), np.uint8)
    lens = np.zeros(len(samples) + 1, np.int32)
    for i, s in enumerate(samples):
        blocks[i, : len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    comp, totals = map(np.array, jax_encode(blocks, lens, True))
    rng = np.random.default_rng(5)
    src = np.array([0, 1, 2])
    mutated = comp[src].copy()
    for i, j in enumerate(src):
        for _ in range(1 + i):
            mutated[i, int(rng.integers(0, totals[j]))] ^= int(rng.integers(1, 256))
    comp = np.concatenate([comp, mutated])
    totals = np.concatenate([totals, totals[src]]).astype(np.int32)
    lens = np.concatenate([lens, lens[src]]).astype(np.int32)
    return comp, totals, lens


def _port(variant, comp, totals, lens):
    return [t.numpy() for t in port.anatomy(variant, *(torch.from_numpy(a) for a in (comp, totals, lens)))]


@pytest.mark.parametrize("variant", port.VARIANTS)
def test_final_cursor_equals_jax_ok_tile(variant):
    comp, totals, lens = _batch()
    img, ok, opc, fold = _port(variant, comp, totals, lens)
    _out, ok_tile = _jax_tool()["make_decoder"](variant)(comp, totals, lens)
    ok_tile = np.asarray(ok_tile)
    assert (ok_tile == ok_tile[:, :1, :1]).all()
    np.testing.assert_array_equal(opc, ok_tile[:, 0, 0])
    assert ok[: len(lens) - 3].all() and not ok.all()  # the mutated copies include a rejected one
    if variant in ("parse", "window"):
        assert not img.any()
    if variant in ("parse", "full"):
        assert not fold.any()
    else:
        assert fold[:4].all() and fold[4] == 0  # the zero-length block reads nothing


def test_full_equals_jax_block_decoder():
    comp, totals, lens = _batch()
    img, ok, _opc, _fold = _port("full", comp, totals, lens)
    jout, jok = map(np.asarray, jax_vm2(comp, totals, lens))
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(img[ok], jout[jok])


def test_window_fold_of_a_literal_block_is_its_word_xor():
    """A block of random bytes encodes as literals only: window reads every
    output byte at its own position, so the fold is the XOR of the decoded
    row's little-endian words.  Every literal of fixed reads compressed
    bytes 64, 65, ... to image bytes 0, 1, ..., so its image is a prefix of
    those bytes (the longest literal's) and zeros."""
    raw = np.frombuffer(corpus.random_bytes(BS, seed=9), np.uint8)
    comp, totals = map(np.array, jax_encode(raw.reshape(1, BS), np.array([BS], np.int32), True))
    lens = np.array([BS], np.int32)
    _img, ok, opc, fold = _port("window", comp, totals, lens)
    assert ok[0] and opc[0] == BS
    assert fold.view(np.uint32)[0] == np.bitwise_xor.reduce(raw.view("<u4"))
    fimg = _port("fixed", comp, totals, lens)[0][0]
    differ = np.nonzero(fimg != comp[0, 64 : 64 + BS])[0]
    prefix = differ[0] if differ.size else BS
    assert prefix >= 60 and not fimg[prefix:].any()


def test_unknown_variant_is_refused():
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        port.anatomy("merge", torch.zeros((1, C.MAX_COMPRESSED_BLOCK_SIZE), dtype=torch.uint8), z, z)


def test_empty_batch():
    z = torch.zeros(0, dtype=torch.int32)
    img, ok, opc, fold = port.anatomy("full", torch.zeros((0, C.MAX_COMPRESSED_BLOCK_SIZE), dtype=torch.uint8), z, z)
    assert img.shape == (0, BS) and ok.shape == opc.shape == fold.shape == (0,)
