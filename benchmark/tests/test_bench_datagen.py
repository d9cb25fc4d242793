import numpy as np
import pytest
import torch

from benchmark import datagen
from snappytpu_torch import api

CONFIG = {"name": "t", "contents": "rdg", "match_proba": 0.5, "lit_proba": 0.0}


@pytest.mark.parametrize("workload", ["synth50-fast.whole-compress", "synth50-dense.whole-compress"])
def test_objects_are_their_sizes_and_fixed_by_the_seed(workload, tiny):
    cell = tiny(workload, divisor=100)
    a = datagen.make_objects(cell.config, 2**33 + 5, "cpu")
    b = datagen.make_objects(cell.config, 2**33 + 5, "cpu")
    c = datagen.make_objects(cell.config, 2**33 + 6, "cpu")
    assert list(a) == list(cell.config["objects"])
    for name, size in cell.config["objects"].items():
        assert a[name].dtype == np.uint8 and a[name].size == size
        assert np.array_equal(a[name], b[name])
        assert not np.array_equal(a[name], c[name])
        assert not a[name].flags.writeable


def test_the_sample_is_zstds_size(tiny):
    cell = tiny("synth50-fast.whole-compress", divisor=1)
    assert cell.config["objects"] == {"sample": 10_000_000}  # BMK_syntheticTest's benchedSize
    assert datagen.make_object(cell.config, "sample", 7, "cpu").numel() == 10_000_000


def test_both_configurations_hold_the_same_sample(tiny):
    fast, dense = (tiny(w, divisor=100).config for w in ("synth50-fast.whole-compress", "synth50-dense.whole-compress"))
    assert np.array_equal(datagen.make_objects(fast, 3, "cpu")["sample"], datagen.make_objects(dense, 3, "cpu")["sample"])


def test_the_literal_table_is_datagens():
    """RDG_fillLiteralDistrib at zstd's default literal probability, 0.5 / 4.5:
    the weight 28/256 in fixed point; '0' first with (8192 * 28 >> 8) + 1 entries."""
    t = datagen.literal_table(0.5 / 4.5).tolist()
    assert len(t) == 8192 and t[:897] == [ord("0")] * 897 and t[897] == ord("1")
    assert set(t) <= set(range(ord("("), ord("}") + 1))
    runs = [len(list(g)) for _, g in __import__("itertools").groupby(t)]
    assert runs[:-1] == sorted(runs[:-1], reverse=True)  # weights fall as the table fills
    assert datagen.literal_table(0.0).tolist() == [u % 256 for u in range(8192)]  # no literal weight: every byte once


def _sequential(p: datagen.Plan, n: int) -> bytes:
    """RDG_genBlock's loop, one operation and one byte at a time, on the plan's draws."""
    is_match, length, repeat, drawn = (t.tolist() for t in (p.is_match, p.length, p.repeat, p.drawn))
    lit = p.literals.tolist()
    buf, pos, prev = bytearray(n), 1, 1
    buf[0] = lit[0]
    for m, ln, rep, off in zip(is_match, length, repeat, drawn):
        d = min(pos + ln, n)
        if m:
            off = prev if rep else min(off, pos)
            while pos < d:
                buf[pos] = buf[pos - off]
                pos += 1
            prev = off
        else:
            while pos < d:
                buf[pos] = lit[pos]
                pos += 1
    assert pos == n
    return bytes(buf)


@pytest.mark.parametrize("match_proba,seed", [(0.5, 1), (0.5, 2**40), (0.9, 3), (0.1, 4)])
def test_the_vectorised_sample_is_the_sequential_loops(match_proba, seed):
    n = 60_000
    p = datagen.plan(n, match_proba, 0.0, datagen._generator(seed, "cpu"), "cpu")
    assert bytes(datagen.materialise(p, n).numpy()) == _sequential(p, n)


def test_the_draws_have_datagens_distributions():
    """Match share P, lengths short (0-15) 3 times in 4 else 15-526, a
    match 4 longer, one match in 16 repeating the last offset, offsets 1-32,768."""
    p = datagen.plan(4_000_000, 0.5, 0.0, datagen._generator(9, "cpu"), "cpu")
    m = p.is_match
    assert abs(m.float().mean().item() - 0.5) < 0.01
    base = torch.where(m, p.length - 4, p.length)
    assert int(base.min()) == 0 and int(base.max()) == 526
    assert abs((base <= 14).float().mean().item() - 0.75 * 15 / 16) < 0.01
    assert abs(p.repeat[m].float().mean().item() - 1 / 16) < 0.01
    assert int(p.drawn.min()) == 1 and int(p.drawn.max()) == 32768
    assert torch.all(p.offset[m] <= p.start[m]) and torch.all(p.offset[m] >= 1)


def test_subseed_takes_large_seeds():
    s = datagen.subseed(2**40 + 3, "rdg", "sample")
    assert 0 <= s < 2**63
    assert s != datagen.subseed(2**40 + 4, "rdg", "sample")
    torch.Generator().manual_seed(s)


def test_every_seed_gives_the_same_work():
    """The port's ratio on two seeds' samples of 1 MB within 1.5 %."""
    a, b = (datagen.make_object(CONFIG | {"objects": {"s": 1_000_000}}, "s", s, "cpu").numpy() for s in (1, 2**35 + 1))
    assert not np.array_equal(a, b)
    ra, rb = (a.size / len(api.compress(x, "fast", device="cpu")) for x in (a, b))
    assert abs(ra / rb - 1) < 0.015, (ra, rb)
