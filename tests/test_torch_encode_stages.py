"""The port's encoder stages against the JAX encoder's, stage by stage.

Each one-block fixture goes through snappytpu.kernels.encode_v2 (on the CPU)
and snappytpu_torch.kernels.encode_v2 (torch on the CPU); every stage array
must be equal, element for element.  Integer codec: the tolerance is exact
equality throughout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappytpu.bench import corpus
from snappytpu.kernels import encode_v2 as J
from snappytpu_torch.kernels import encode_v2 as T

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

CASES = {
    "text_12k": corpus.text(12_000),
    "lowent_8k": corpus.low_entropy(8_000),
    "records_10k": corpus.structured_binary(10_000),
    "random_4k": corpus.random_bytes(4_000),
    "abc_periodic": (b"abcabcabc" * 400)[:3_500],
}


def _jax(name, dense):
    """The JAX stage arrays for one fixture, each stage jitted."""
    blocks, n = _block(name)
    b, l = jnp.asarray(blocks), jnp.asarray(n)
    tiers = _jit_matches(dense)(b, l)
    inh = _jit(J._inherit)(tiers, l)
    el = _jit(J._elect)(tiers, inh, l)
    rg = _jit(J._reglue)(b, *el, l)
    return jax.tree_util.tree_map(np.asarray, (tiers, J._best_tier(tiers), inh, el, rg))


@functools.cache
def _jit_matches(dense):
    return jax.jit(lambda b, l: J._find_matches(b, l, dense=dense))


_jit = functools.cache(jax.jit)


def _block(name):
    data = np.frombuffer(CASES[name], np.uint8)
    blocks = np.zeros((1, J.BS), np.uint8)
    blocks[0, : data.size] = data
    return blocks, np.array([data.size], np.int32)


def _torch(name, dense):
    blocks, n = _block(name)
    b, l = torch.from_numpy(blocks), torch.from_numpy(n)
    tiers = T._find_matches(b, l, dense=dense)
    inh = T._inherit(tiers, l)
    el = T._elect(tiers, inh, l)
    rg = T._reglue(b, *el, l)
    return tiers, T._best_tier(tiers), inh, el, rg


def _same(jarrs, tarrs, what):
    assert len(jarrs) == len(tarrs), what
    for i, (j, t) in enumerate(zip(jarrs, tarrs)):
        t = t.numpy()
        assert j.shape == t.shape, f"{what}[{i}] shape {j.shape} vs {t.shape}"
        np.testing.assert_array_equal(t, j, err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fast"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_stages_equal_jax(name, dense):
    j_tiers, j_best, j_inh, j_el, j_rg = _jax(name, dense)
    t_tiers, t_best, t_inh, t_el, t_rg = _torch(name, dense)
    assert len(j_tiers) == len(t_tiers)
    for k, (jt, tt) in enumerate(zip(j_tiers, t_tiers)):
        _same(jt, tt, f"_find_matches tier {k}")
    _same(j_best, t_best, "_best_tier")
    _same(j_inh, t_inh, "_inherit")
    _same(j_el, t_el, "_elect")
    _same(j_rg, t_rg, "_reglue")


def test_helpers_equal_jax():
    """The word and LCP helpers, on random words with planted shared prefixes."""
    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 4, (2, J.BS), dtype=np.uint8)  # small alphabet: long common prefixes
    jw = np.asarray(J._words(jnp.asarray(blocks)))
    tw = T._words(torch.from_numpy(blocks))
    np.testing.assert_array_equal(tw.numpy(), jw.astype(np.int64))
    for k in (1, 4, 60):
        np.testing.assert_array_equal(
            T._shift_words(tw, k).numpy(), np.asarray(J._shift_words(jnp.asarray(jw), k)).astype(np.int64)
        )
    ks_j = tuple(J._shift_words(jnp.asarray(jw), 4 * i) if i else jnp.asarray(jw) for i in range(4))
    ks_t = tuple(T._shift_words(tw, 4 * i) if i else tw for i in range(4))
    for sh in (1, 2, 3):
        np.testing.assert_array_equal(
            T._neighbor_lcp(ks_t, sh).numpy(), np.asarray(J._neighbor_lcp(ks_j, sh))
        )
    np.testing.assert_array_equal(
        T._word_lcp(tw, T._shifted(tw, 1, 0)).numpy(),
        np.asarray(J._word_lcp(jnp.asarray(jw), J._shifted(jnp.asarray(jw), 1, 0))),
    )


def test_lex_order_is_stable_lexicographic():
    """The packed-key LSD sort equals numpy's stable lexsort over u32 keys,
    including keys at the top of the unsigned range."""
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 3, (5, 2, 4000)).astype(np.int64) * 0x7FFFFFFF  # 0, 2^31-1, 2^32-2
    keys[1] = rng.integers(0, 2**32, (2, 4000))
    got = T._lex_order([torch.from_numpy(k) for k in keys]).numpy()
    for r in range(2):
        want = np.lexsort(tuple(k[r] for k in keys[::-1]))
        np.testing.assert_array_equal(got[r], want)


def _adversarial_election():
    """The densest legal emission geometry (tests/test_encode_v2.py's
    capacity case): COPY2 anchors every 17th tile over period-4000 data."""
    rng = np.random.default_rng(23)
    dist = 4000
    data = np.resize(rng.integers(0, 256, dist, dtype=np.uint8), J.BS)
    is_copy = np.zeros((1, J.NA), bool)
    is_copy[0, dist // J.G :: 17] = True
    ad = np.where(is_copy, dist, 0).astype(np.int32)
    zeros = np.zeros((1, J.NA), np.int32)
    return data[None, :], is_copy, ad, zeros, zeros.copy(), np.array([J.BS], np.int32)


@pytest.mark.parametrize("seccap", [None, J.BS // J._NSEC], ids=["derived", "too_small"])
def test_emit_and_capacity_guard_equal_jax(seccap):
    args = _adversarial_election()
    jc, jt = J._emit(*map(jnp.asarray, args), seccap=seccap)
    tc, tt = T._emit(*map(torch.from_numpy, args), seccap=seccap)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (int(tt[0]) == -1) == (seccap is not None)
