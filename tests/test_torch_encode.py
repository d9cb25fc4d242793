"""The port's encoder output against the JAX encoder's: every compressed row
(all 73728 bytes, zero padding included) and every total, both profiles.

All fixtures' blocks ride one batch per profile, so JAX compiles once.
Byte identity is how the JAX encoder's size contracts (the fast aggregate
ratio, dense never larger than the reference C codec) reach the port.
"""

import functools

import numpy as np
import pytest
import torch

from snappytpu.bench import corpus
from snappytpu.kernels.encode_v2 import encode_blocks_v2 as jax_encode
from snappytpu.stream import framing
from snappytpu_torch.kernels.encode_v2 import encode_blocks_v2 as torch_encode

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

CASES = dict(corpus.edge_case_corpus())
CASES["mixed200k"] = corpus.mixed(200_000, seed=8)
CASES["periodic_text_100k"] = (b"snappy on tpu! " * 7000)[:100_000]
NAMES = sorted(CASES)


def _batch():
    """All fixtures' blocks in one (B, 65536) batch + lens + per-case row ranges."""
    blocks, lens, spans = [], [], {}
    for name in NAMES:
        b, l = framing.pack_blocks(np.frombuffer(CASES[name], np.uint8))
        start = sum(x.shape[0] for x in blocks)
        spans[name] = (start, start + b.shape[0])
        blocks.append(b)
        lens.append(l)
    return np.concatenate(blocks), np.concatenate(lens), spans


@functools.cache
def _encoded(dense):
    blocks, lens, spans = _batch()
    jc, jt = jax_encode(blocks, lens, dense)
    tc, tt = torch_encode(torch.from_numpy(blocks), torch.from_numpy(lens), dense)
    return (np.asarray(jc), np.asarray(jt)), (tc.numpy(), tt.numpy()), spans


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fast"])
@pytest.mark.parametrize("name", NAMES)
def test_rows_and_totals_equal_jax(name, dense):
    (jc, jt), (tc, tt), spans = _encoded(dense)
    a, b = spans[name]
    assert tc.dtype == np.uint8 and tc[a:b].shape == (b - a, 73728)
    np.testing.assert_array_equal(tt[a:b], jt[a:b], err_msg="totals")
    np.testing.assert_array_equal(tc[a:b], jc[a:b], err_msg="rows")
    assert (tt[a:b] > 0).all() or CASES[name] == b""


def test_batch_position_does_not_matter():
    """A block encodes to the same row alone as inside a batch."""
    blocks, lens, spans = _batch()
    a, _ = spans["mixed200k"]
    (_, _), (tc, tt), _ = _encoded(False)
    c1, t1 = torch_encode(torch.from_numpy(blocks[a : a + 1]), torch.from_numpy(lens[a : a + 1]), False)
    np.testing.assert_array_equal(c1.numpy()[0], tc[a])
    assert int(t1[0]) == tt[a]


def test_rejects_wrong_shapes():
    with pytest.raises(ValueError):
        torch_encode(torch.zeros((1, 100), dtype=torch.uint8), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        torch_encode(torch.zeros((2, 65536), dtype=torch.uint8), torch.zeros(1, dtype=torch.int32))
