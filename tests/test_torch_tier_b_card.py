"""Tier B's route: K7 on a CUDA tensor, the torch chain elsewhere.

On the CPU: `_tier_b` hands a CUDA tensor's blocks to K7 with its profile's
and knobs' parameters and runs the chain on a CPU tensor, and the carried
key words are built where a stage first reads them (so a card builds only
tier A's).  On a card (marked `cuda`, skipped without one): K7's (length,
distance) equal the chain's on the same card at 128 and 25 blocks in both
profiles and under the tools' knobs, with no `torch.sort` in `_tier_b`; and
`encode_v2`'s rows and totals equal the chain's encoding across an eager
call, a capture and a replay, K7 counted once a call (`tier_b.launches` +
`tier_b.graph_runs`).  Run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_tier_b_card.py -q`
(this file imports neither JAX nor the JAX package)."""

import numpy as np
import pytest
import torch

from benchmark import datagen
from snappytpu_torch import profiling
from snappytpu_torch.kernels import encode_v2 as E
from snappytpu_torch.tools.enc_variants import K12SAMP

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

BS = E.BS
# (dense, _tier_b's knobs): the two profiles and the encoder tools' tier-B knobs
VARIANTS = {
    "dense": (True, {}),
    "fast": (False, {}),
    "k8": (True, dict(dense_keys=tuple(range(8)))),
    "k12samp": (True, dict(dense_keys=K12SAMP)),
    "b_ranks_1_2_3": (True, dict(b_ranks=(1, 2, 3))),
    "fast_b_ranks_1_2_3": (False, dict(b_ranks=(1, 2, 3))),
}
LENGTHS = (0, 1, 3, 4, 5, 63, 64, 65, 4097, 30000)


def _batch(B, seed, device):
    """B blocks of the zstd 50 % sample, rows 10-14 of zeros, of 0xFF, of
    periods 3 and 64 and of noise, rows 0-9 cut to LENGTHS, the rest full."""
    blocks = datagen.rdg(B * BS, datagen._generator(seed, device), device).view(B, BS).clone()
    g = torch.Generator(device=device).manual_seed(seed)
    blocks[10] = 0
    blocks[11] = 0xFF
    for row, period in ((12, 3), (13, 64)):
        blocks[row] = torch.randint(0, 256, (period,), generator=g, device=device).to(torch.uint8).repeat(BS // period + 1)[:BS]
    blocks[14] = torch.randint(0, 256, (BS,), generator=g, device=device).to(torch.uint8)
    lens = torch.full((B,), BS, dtype=torch.int32, device=device)
    lens[: len(LENGTHS)] = torch.tensor(LENGTHS, dtype=torch.int32, device=device)
    return blocks, lens


def _chain_as_k7(blocks, n, stride, key_ids, b_ranks):
    """K7's call answered by the torch chain, on the blocks' device."""
    return E._tier_b_chain(E._match_words(blocks, n), stride, key_ids, b_ranks)


def _delta(before, *names):
    now = profiling.counters()
    return tuple(now.get(k, 0) - before.get(k, 0) for k in names)


# ---- the route, on the CPU ----


class _CudaBlocks:
    """Stands in for a CUDA tensor of blocks: only its device is read before K7."""

    device = torch.device("cuda", 0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_a_cuda_tensor_goes_to_k7_with_its_parameters(variant, monkeypatch):
    dense, kw = VARIANTS[variant]
    calls = []
    monkeypatch.setattr(E, "tier_b_kernel", lambda *a: calls.append(a) or "k7")
    monkeypatch.setattr(E, "_tier_b_chain", lambda *a: pytest.fail("the chain ran on a CUDA tensor"))
    n = torch.zeros(2, dtype=torch.int32)
    mw = E._MatchWords(n, torch.zeros((2, BS), dtype=torch.int32), None, None, _CudaBlocks())
    assert E._tier_b(mw, dense, **kw) == "k7"
    want_keys = kw.get("dense_keys", tuple(range(16))) if dense else (0, 1, 4, 8, 12, 15)
    assert calls == [(mw.blocks, n, 1 if dense else 4, want_keys, kw.get("b_ranks", (1, 2)))]


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fast"])
def test_a_cpu_tensor_runs_the_chain(dense, monkeypatch):
    monkeypatch.setattr(E, "tier_b_kernel", lambda *a: pytest.fail("K7 ran on a CPU tensor"))
    blocks, lens = _batch(16, seed=3, device="cpu")
    mw = E._match_words(blocks, lens)
    got = E._tier_b(mw, dense)
    want = E._tier_b_chain(mw, *E._tier_b_params(dense))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_key_words_are_built_at_first_read():
    """Tier A builds its words, tier B's chain the rest; each equals the
    word 4j bytes on, indexed or sliced as a tuple."""
    blocks, lens = _batch(16, seed=5, device="cpu")
    mw = E._match_words(blocks[:2], lens[:2])
    assert len(mw.kws) == E.KW and set(mw.kws._built) == {0}
    E._tier_a(mw, True)
    assert set(mw.kws._built) == {0, 1, 2, 3}
    w = E._words(blocks[:2])
    for j, kw in enumerate(mw.kws[:]):
        assert torch.equal(kw, E._shift_words(w, 4 * j) if j else w)
    assert mw.kws[1:3] == (mw.kws[1], mw.kws[2]) and mw.kws[5] is mw.kws[5:6][0]


# ---- on a card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("B", [128, 25])
def test_k7_equals_the_chain_on_the_card(card, B, variant):
    dense, kw = VARIANTS[variant]
    blocks, lens = _batch(B, seed=2400 + B, device=card)
    mw = E._match_words(blocks, lens)
    before = profiling.counters()
    got = E._tier_b(mw, dense, **kw)
    torch.cuda.synchronize(card)
    assert _delta(before, "tier_b.launches", "tier_b.recorded") == (1, 0)
    want = E._tier_b_chain(mw, *E._tier_b_params(dense, **kw))
    for g, w, what in zip(got, want, ("mlen", "dist")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        bad = (g != w).nonzero()
        assert bad.numel() == 0, f"{what}: {bad.shape[0]} positions differ, first (row, pos) {bad[:4].tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fast"])
def test_no_sort_in_tier_b_on_the_card(card, dense, monkeypatch):
    sorts = []
    sort = torch.sort
    monkeypatch.setattr(torch, "sort", lambda *a, **k: sorts.append(1) or sort(*a, **k))
    blocks, lens = _batch(25, seed=2500, device=card)
    E._tier_b(E._match_words(blocks, lens), dense)
    assert sorts == []


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fast"])
@pytest.mark.parametrize("B", [128, 25])
def test_encode_is_unchanged_eager_captured_and_replayed(card, B, dense, monkeypatch):
    """A fresh graph cache's eager call, capture and replay each equal the
    chain's encoding of the same blocks; K7 runs once a call: launched in
    the eager one, inside the graph in the other two."""
    blocks, lens = _batch(B, seed=2600 + B + dense, device=card)
    with monkeypatch.context() as m:
        m.setattr(E, "tier_b_kernel", _chain_as_k7)
        want = E.encode_block_core(blocks, lens, dense)
    cache = E.GraphCache(E._CudaGraphs())
    names = ("tier_b.launches", "tier_b.graph_runs", "encode.eager_calls", "encode.graph_captures",
             "encode.graph_replays")
    steps = []
    for i in range(3):
        before = profiling.counters()
        got = cache.run((card.index, B, dense), lambda b, n: E.encode_block_core(b, n, dense), blocks, lens)
        torch.cuda.synchronize(card)
        steps.append(_delta(before, *names))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"call {i}"
    assert steps == [(1, 0, 1, 0, 0), (0, 1, 0, 1, 0), (0, 1, 0, 0, 1)]
    assert sum(s[0] + s[1] for s in steps) == 3
    assert int(np.count_nonzero(want[1].cpu().numpy() > 0)) == B - 1  # every row but the empty one emits
