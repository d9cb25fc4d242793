"""The port's encoder knobs against the JAX encoder's.

The A/B knobs that the encoder tools turn (`a_ranks`, `b_ranks`,
`dense_keys`, `a_words` of `_find_matches`, `nsec` of `_emit`) go through
snappytpu.kernels.encode_v2 (on the CPU) and snappytpu_torch.kernels.encode_v2
(torch on the CPU) on the same two-block batch; the stage arrays, the
compressed rows and the totals must be equal.  Integer codec: the tolerance
is exact equality throughout.
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

K12SAMP = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 15)

# (knobs, dense): the knob cases of the JAX tools (enc_ablate's a_ranks,
# enc_variants' b_ranks and dense_keys) and a narrower tier A
KNOBS = {
    "a_ranks_1_2": (dict(a_ranks=(1, 2)), False),
    "b_ranks_1_2_3": (dict(b_ranks=(1, 2, 3)), True),
    "k12samp": (dict(dense_keys=K12SAMP), True),
    "k8": (dict(dense_keys=tuple(range(8))), True),
    "a_words_2": (dict(a_words=2), True),
}


@functools.cache
def _batch():
    """Two blocks: a full 64 KiB of the mixed corpus and 20,000 bytes of
    low-entropy runs followed by text."""
    rows = [corpus.mixed(J.BS, seed=31), (corpus.low_entropy(8_000, seed=5) + corpus.text(12_000, seed=6))]
    blocks = np.zeros((len(rows), J.BS), np.uint8)
    for i, r in enumerate(rows):
        blocks[i, : len(r)] = np.frombuffer(r, np.uint8)
    return blocks, np.array([len(r) for r in rows], np.int32)


def _same(t, j, what):
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    j = np.asarray(j)
    assert t.shape == j.shape, f"{what}: shape {t.shape} vs {j.shape}"
    np.testing.assert_array_equal(t, j, err_msg=what)


@pytest.mark.parametrize("case", sorted(KNOBS))
def test_knobs_equal_jax(case):
    kw, dense = KNOBS[case]
    blocks, n = _batch()
    fn = jax.jit(lambda b, l: (J._find_matches(b, l, dense, **kw), J.encode_block_core(b, l, dense, **kw)))
    j_tiers, (j_rows, j_totals) = fn(jnp.asarray(blocks), jnp.asarray(n))
    b, l = torch.from_numpy(blocks), torch.from_numpy(n)
    t_tiers = T._find_matches(b, l, dense, **kw)
    assert len(t_tiers) == len(j_tiers)
    for k, (tt, jt) in enumerate(zip(t_tiers, j_tiers)):
        _same(tt[0], jt[0], f"{case} tier {k} len")
        _same(tt[1], jt[1], f"{case} tier {k} dist")
    t_rows, t_totals = T.encode_block_core(b, l, dense, **kw)
    _same(t_totals, j_totals, f"{case} totals")
    _same(t_rows, j_rows, f"{case} rows")
    assert (t_totals > 0).all()
    # the knob is live: its totals differ from the defaults' on this batch
    # or its tiers do (a_words only narrows tier A's exact LCP)
    d_tiers = T._find_matches(b, l, dense)
    assert any(not torch.equal(x, y) for tt, dt in zip(t_tiers, d_tiers) for x, y in zip(tt, dt))


@functools.cache
def _election(dense):
    """The port's election for the batch (its stages equal the JAX
    encoder's: tests/test_torch_encode_stages.py)."""
    blocks, n = _batch()
    b, l = torch.from_numpy(blocks), torch.from_numpy(n)
    tiers = T._find_matches(b, l, dense)
    el = T._elect(tiers, T._inherit(tiers, l), l)
    return (b, *T._reglue(b, *el, l), l)


@pytest.mark.parametrize("nsec", [16, 32, 128])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fast"])
def test_nsec_rows_equal_jax_and_the_default(nsec, dense):
    args = _election(dense)
    t_rows, t_totals = T._emit(*args, nsec=nsec)
    j_rows, j_totals = jax.jit(functools.partial(J._emit, nsec=nsec))(*(jnp.asarray(a.numpy()) for a in args))
    _same(t_totals, j_totals, f"nsec {nsec} totals")
    _same(t_rows, j_rows, f"nsec {nsec} rows")
    d_rows, d_totals = T._emit(*args)
    assert torch.equal(t_totals, d_totals) and torch.equal(t_rows, d_rows)


def test_nsec_128_small_seccap_poisons_as_jax():
    """Row 0 emits at the densest legal geometry (a COPY2 every 17th tile
    over period-4000 data, ~1.015 bytes a position), row 1 is 300 bytes of
    literal: with 512-byte sections of 512 positions row 0 overflows, row 1
    does not."""
    rng = np.random.default_rng(23)
    dist = 4000
    data = np.resize(rng.integers(0, 256, dist, dtype=np.uint8), J.BS)
    blocks = np.stack([data, data])
    is_copy = np.zeros((2, J.NA), bool)
    is_copy[0, dist // J.G :: 17] = True
    ad = np.where(is_copy, dist, 0).astype(np.int32)
    zeros = np.zeros((2, J.NA), np.int32)
    n = np.array([J.BS, 300], np.int32)
    args = (blocks, is_copy, ad, zeros, zeros.copy(), n)
    j_rows, j_totals = J._emit(*map(jnp.asarray, args), nsec=128, seccap=512)
    t_rows, t_totals = T._emit(*map(torch.from_numpy, args), nsec=128, seccap=512)
    _same(t_totals, j_totals, "poisoned totals")
    _same(t_rows, j_rows, "poisoned rows")
    assert t_totals.tolist()[0] == -1 and t_totals.tolist()[1] == 303


@pytest.mark.parametrize("nsec", [0, -64, 3, 48, 65537, 64.0])
def test_nsec_not_dividing_the_block_raises(nsec):
    args = _election(False)
    with pytest.raises(ValueError, match="nsec"):
        T._emit(*args, nsec=nsec)
    with pytest.raises(ValueError, match="nsec"):
        T.encode_block_core(args[0], args[-1], False, nsec=nsec)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fast"])
def test_geometry_total_is_the_emit_total(dense):
    args = _election(dense)
    g = T._emit_geometry(*args)
    _rows, total = T._emit(*args)
    assert torch.equal(g.total, total)
    assert torch.equal(g.total, g.size.sum(dim=1, dtype=torch.int32))


@pytest.mark.parametrize("variant", ["no tier B", "no run tiers"])
def test_ablation_without_a_tier_equals_jax(variant):
    """enc_ablate's variants that take out a tier skip its code; their rows
    are the JAX tool's, which drops the tier from the list."""
    from snappytpu_torch.tools import enc_ablate

    sel = {"no tier B": lambda t: [t[0]] + t[2:], "no run tiers": lambda t: t[:2]}[variant]

    def jax_pipe(b, l):
        tiers = sel(J._find_matches(b, l, dense=False))
        el = J._elect(tiers, J._inherit(tiers, l), l)
        return J._emit(b, *J._reglue(b, *el, l), l)

    blocks, n = _batch()
    j_rows, j_totals = jax.jit(jax_pipe)(jnp.asarray(blocks), jnp.asarray(n))
    t_rows, t_totals = enc_ablate.pipe(torch.from_numpy(blocks), torch.from_numpy(n), **enc_ablate.VARIANTS[variant])
    _same(t_totals, j_totals, f"{variant} totals")
    _same(t_rows, j_rows, f"{variant} rows")
