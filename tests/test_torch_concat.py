"""K1 (row concatenation): the port's plain version against the JAX Pallas
kernel (interpret mode on the CPU), at the encoder's shape (64 sections of
384 words into 73728-byte rows) and a small one.  Exact byte equality."""

import functools

import numpy as np
import pytest
import torch

from snappytpu.kernels.concat import concat_rows_words as jax_concat
from snappytpu_torch.kernels import concat

OUT_CAP = 73728
S, CAPW = 64, 384  # the encoder's sections and words per section
CAP = 4 * CAPW


def _lens(kind, rng, B):
    if kind == "zero":
        return np.zeros((B, S), np.int32)
    if kind == "full":  # every section at capacity, 48 of them: 73728 exactly
        ln = np.zeros((B, S), np.int32)
        ln[:, :48] = CAP
        return ln
    if kind == "one":
        return np.ones((B, S), np.int32)
    if kind == "odd":
        return (2 * rng.integers(0, 576, (B, S)) + 1).astype(np.int32)  # <= 1151 each
    if kind == "near_cap":  # sums just under the row
        ln = rng.integers(1000, 1200, (B, S)).astype(np.int32)
        ln[:, -1] = 0
        ln[:, -1] = OUT_CAP - 3 - ln.sum(1)
        return np.clip(ln, 0, CAP)
    return rng.integers(0, CAP + 1, (B, S)).astype(np.int32) // 2  # random


KINDS = ["zero", "full", "one", "odd", "near_cap", "random"]


@functools.cache
def _inputs(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    words = rng.integers(-2**31, 2**31, (3, S, CAPW), dtype=np.int64).astype(np.int32)
    lens = _lens(kind, rng, 3)
    assert (lens >= 0).all() and (lens <= CAP).all() and (lens.sum(1) <= OUT_CAP).all()
    return words, lens


@pytest.mark.parametrize("kind", KINDS)
def test_plain_concat_equals_jax(kind):
    words, lens = _inputs(kind)
    want = np.asarray(jax_concat(words, lens, OUT_CAP))
    got = concat.concat_rows_words(torch.from_numpy(words), torch.from_numpy(lens), OUT_CAP)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, OUT_CAP)
    np.testing.assert_array_equal(got.numpy(), want)


def test_small_shape_equals_jax():
    rng = np.random.default_rng(41)
    words = rng.integers(-2**31, 2**31, (2, 5, 128), dtype=np.int64).astype(np.int32)
    lens = np.array([[0, 511, 1, 512, 3], [7, 0, 0, 300, 180]], np.int32)
    want = np.asarray(jax_concat(words, lens, 1536))
    got = concat.concat_rows_words(torch.from_numpy(words), torch.from_numpy(lens), 1536)
    np.testing.assert_array_equal(got.numpy(), want)


def test_u8_entry_matches_words_entry():
    words, lens = _inputs("random")
    w = torch.from_numpy(words)
    np.testing.assert_array_equal(
        concat.concat_rows(w.view(torch.uint8), torch.from_numpy(lens), OUT_CAP).numpy(),
        concat.concat_rows_words(w, torch.from_numpy(lens), OUT_CAP).numpy(),
    )


@pytest.mark.parametrize("bad", ["negative", "over_cap", "over_row"])
def test_cpu_wrapper_rejects_contract_violations(bad):
    pieces = torch.zeros((1, 4, 64), dtype=torch.uint8)
    lens = {"negative": [-1, 0, 0, 0], "over_cap": [65, 0, 0, 0], "over_row": [64, 64, 64, 64]}[bad]
    with pytest.raises(ValueError):
        concat.concat_rows(pieces, torch.tensor([lens], dtype=torch.int32), 192)
