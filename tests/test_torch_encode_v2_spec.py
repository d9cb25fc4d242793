"""The executable-spec contract on the port: the port's numpy spec
(snappytpu_torch/model/encode_v2_spec.py) equals the JAX package's spec on
every intermediate and on the bytes, and the port's encoder
(kernels/encode_v2.py, torch on the CPU) agrees with the spec stage by
stage — matches -> inherit -> elect -> reglue, compared elementwise under
the same masks as tests/test_encode_v2_spec.py — and emits the same bytes.

The six cases are those of tests/test_encode_v2_spec.py, except that the
CSV case is read from the in-repo Test_results_tpu/ (the same schema as the
reference checkout's file that test reads).  Integer codec: the tolerance
is exact equality.
"""

import functools
import os

import numpy as np
import pytest
import torch

from snappytpu.model import encode_v2_spec as JS
from snappytpu_torch.bench import corpus
from snappytpu_torch.kernels import encode_v2 as E
from snappytpu_torch.model import encode_v2_spec as S
from snappytpu_torch.model.decode import decode_ops

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

_CSV = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "Test_results_tpu",
                    "compression_results_cpu_dense.csv")

CASES = {
    "text_12k": corpus.text(12_000),
    "lowent_8k": corpus.low_entropy(8_000),
    "records_10k": corpus.structured_binary(10_000),
    "random_4k": corpus.random_bytes(4_000),
    "abc_periodic": (b"abcabcabc" * 400)[:3_500],
    "csv_head": open(_CSV, "rb").read()[:9_000],
}


def _block(name):
    data = np.frombuffer(CASES[name], np.uint8)
    block = np.zeros(S.BS, np.uint8)
    block[: data.size] = data
    return block, data.size


@functools.cache
def _spec(name):
    return S.spec_encode_block(*_block(name), dense=True)


def _port_stages(block: np.ndarray, n: int):
    blocks = torch.from_numpy(block[None, :])
    lens = torch.tensor([n], dtype=torch.int32)
    tiers = E._find_matches(blocks, lens, dense=True)
    mlen, dist = E._best_tier(tiers)
    inh = E._inherit(tiers, lens)
    el = E._elect(tiers, inh, lens)
    rg = E._reglue(blocks, *el, lens)
    comp, totals = E._emit(blocks, *rg, lens)
    return (mlen[0].numpy(), dist[0].numpy(), tuple(x[0].numpy() for x in inh), tuple(x[0].numpy() for x in rg),
            comp[0, : int(totals[0])].numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_spec_equals_jax_spec(name):
    s_bytes, s = _spec(name)
    j_bytes, j = JS.spec_encode_block(*_block(name), dense=True)
    assert s_bytes == j_bytes
    assert s.keys() == j.keys()
    for key in ("mlen", "dist", "is_copy", "ad", "lead", "tail"):
        np.testing.assert_array_equal(s[key], j[key], err_msg=key)
    for a, b in zip(s["inherit"], j["inherit"]):
        np.testing.assert_array_equal(a, b, err_msg="inherit")
    assert s["intervals"] == j["intervals"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_encoder_matches_spec(name):
    block, n = _block(name)
    d_mlen, d_dist, d_inh, d_rg, d_bytes = _port_stages(block, n)
    s_bytes, s = _spec(name)

    # stage 1: per-position best match
    np.testing.assert_array_equal(d_mlen[:n], s["mlen"][:n], err_msg="mlen")
    live = s["mlen"][:n] > 0
    np.testing.assert_array_equal(d_dist[:n][live], s["dist"][:n][live], err_msg="dist")

    # stage 2: inherited per-anchor winner
    r2, d2, _s2 = s["inherit"]
    na_n = (n + S.G - 1) // S.G
    np.testing.assert_array_equal(d_inh[0][:na_n], r2[:na_n], err_msg="inherit reach")
    inh_live = r2[:na_n] >= 0
    np.testing.assert_array_equal(d_inh[1][:na_n][inh_live], d2[:na_n][inh_live], err_msg="inherit dist")

    # stages 3+4: post-reglue election state
    np.testing.assert_array_equal(d_rg[0][:na_n], s["is_copy"][:na_n], err_msg="is_copy")
    cp = s["is_copy"][:na_n]
    np.testing.assert_array_equal(d_rg[1][:na_n][cp], s["ad"][:na_n][cp], err_msg="ad")
    np.testing.assert_array_equal(d_rg[2][:na_n][cp], s["lead"][:na_n][cp], err_msg="lead")
    np.testing.assert_array_equal(d_rg[3][:na_n][cp], s["tail"][:na_n][cp], err_msg="tail")

    # stage 5: byte-identical stream, and it must decode
    assert d_bytes.tobytes() == s_bytes, "emitted bytes differ"
    data = CASES[name]
    assert decode_ops(np.frombuffer(s_bytes, np.uint8), n).tobytes() == data


def test_the_csv_case_is_real_csv():
    """The in-repo stand-in keeps the case what it was: the head of a
    results CSV, text with commas and newlines."""
    head = CASES["csv_head"]
    assert head.startswith(b"input_size,output_size,comp_ratio") and head.count(b"\n") > 5
