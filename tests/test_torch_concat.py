"""K1 (row concatenation): the port's plain version against the JAX Pallas
kernel (interpret mode on the CPU), at the encoder's shape (64 sections of
384 words into 73728-byte rows) and a small one.  Exact byte equality."""

import functools

import numpy as np
import pytest
import torch

from snappytpu.kernels.concat import concat_rows_words as jax_concat
from snappytpu_torch import profiling
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


def _alignment_case(case, device):
    """(pieces, out_cap) breaking the CUDA route's alignment contract in one
    way: cap or out_cap not a multiple of 16, or pieces at a storage offset
    of one byte; "aligned" breaks nothing."""
    base = torch.zeros(2 * 4 * 64 + 16, dtype=torch.uint8, device=device)
    pieces = base[: 2 * 4 * 64].view(2, 4, 64)
    if case == "cap":
        pieces = base[: 2 * 4 * 60].view(2, 4, 60)
    elif case == "offset":
        pieces = base[1 : 1 + 2 * 4 * 64].view(2, 4, 64)
    return pieces, 200 if case == "out_cap" else 256


@pytest.mark.parametrize("case", ["cap", "out_cap", "offset", "aligned"])
def test_alignment_predicate(case):
    """The predicate the CUDA route runs before every launch, on CPU tensors'
    pointers: ValueError exactly where the contract breaks."""
    pieces, out_cap = _alignment_case(case, "cpu")
    out = torch.empty((2, out_cap), dtype=torch.uint8)
    if case == "aligned":
        concat.check_aligned(pieces.shape[2], out_cap, pieces.data_ptr(), out.data_ptr())
    else:
        with pytest.raises(ValueError, match="16"):
            concat.check_aligned(pieces.shape[2], out_cap, pieces.data_ptr(), out.data_ptr())
    # the CPU route keeps the plain version, aligned or not
    got = concat.concat_rows(pieces, torch.full((2, 4), 3, dtype=torch.int32), out_cap)
    np.testing.assert_array_equal(got.numpy(), concat.concat_rows_ref(pieces, torch.full((2, 4), 3), out_cap).numpy())


@pytest.mark.parametrize("case", ["cap", "out_cap", "offset"])
def test_cuda_route_raises_outside_alignment(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pieces, out_cap = _alignment_case(case, "cuda")
    before = profiling.counters().get("concat.launches", 0)
    with pytest.raises(ValueError, match="16"):
        concat.concat_rows(pieces, torch.ones((2, 4), dtype=torch.int32, device="cuda"), out_cap)
    assert profiling.counters().get("concat.launches", 0) == before
