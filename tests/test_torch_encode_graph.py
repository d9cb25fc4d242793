"""The encoder's CUDA graph path (`encode_v2.encode_blocks_v2`).

On the CPU: the dispatch policy, `GraphCache`, with an injected capture
function (a key's first call eager, its second captured, later ones
replayed; every graph kept; a capture that raises; the counters), which
calls have a key at all, and the CPU path, which never reaches the cache.
On a card (marked `cuda`, skipped without one): the graph's rows and totals
equal the eager chain's byte for byte in both profiles at 1, 25 and 128
blocks, interleaved shapes, which share one memory pool and one set of
static inputs, keep every returned result intact, and a replay counts the
K1 runs its graph recorded.  Run them
there with `python -m pytest --noconftest -m cuda tests/test_torch_encode_graph.py -q`
(this file imports neither JAX nor the JAX package)."""

import sys
import threading
from types import SimpleNamespace

import pytest
import torch

from snappytpu_torch import api, profiling
from snappytpu_torch.kernels import encode_v2 as E

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

COUNTERS = ("encode.graph_replays", "encode.graph_captures", "encode.eager_calls", "encode.graph_fallbacks")


def _counts(before=None):
    """The encoder's counters now, less `before`."""
    now = profiling.counters()
    return {k: now.get(k, 0) - (before or {}).get(k, 0) for k in COUNTERS}


def _delta(replays=0, captures=0, eager=0, fallbacks=0):
    return dict(zip(COUNTERS, (replays, captures, eager, fallbacks)))


class Capture:
    """A capture function for GraphCache: records the keys it captured and
    returns a replay that says which key answered; raises for `refused`."""

    def __init__(self, refused=()):
        self.keys, self.refused = [], set(refused)

    def __call__(self, key, x):
        self.keys.append(key)
        if key in self.refused:
            raise RuntimeError("operation not permitted when stream is capturing")
        return lambda x: ("replay", key, x)


def eager(x):
    return ("eager", x)


def _state(cache):
    return (set(cache.graphs), set(cache.seen), set(cache.eager))


# ---- the policy, on the CPU ----


def test_first_call_eager_second_captures_third_replays():
    cap = Capture()
    cache = E.GraphCache(cap)
    key = (0, 128, True)
    got = []
    for i in range(4):
        before = _counts()
        got.append((cache.run(key, eager, i), _counts(before)))
    assert got == [(("eager", 0), _delta(eager=1)), (("replay", key, 1), _delta(captures=1)),
                   (("replay", key, 2), _delta(replays=1)), (("replay", key, 3), _delta(replays=1))]
    assert cap.keys == [key]


@pytest.mark.parametrize("calls", [1, 2, 3, 7])
def test_each_call_counts_once(calls):
    """Of n calls of one key: one eager, one capture, n - 2 replays."""
    cache = E.GraphCache(Capture())
    before = _counts()
    for i in range(calls):
        cache.run((0, 25, False), eager, i)
    assert _counts(before) == _delta(replays=max(calls - 2, 0), captures=int(calls >= 2), eager=1)


def test_a_key_without_a_graph_path_runs_eagerly():
    """key None (a CPU tensor, an empty batch, a call inside another capture)
    runs the chain and leaves the cache as it was."""
    cap = Capture()
    cache = E.GraphCache(cap)
    before = _counts()
    assert [cache.run(None, eager, i) for i in range(3)] == [("eager", i) for i in range(3)]
    assert _counts(before) == _delta(eager=3)
    assert cap.keys == [] and _state(cache) == (set(), set(), set())


def test_profiles_and_devices_are_keys_of_their_own():
    cap = Capture()
    cache = E.GraphCache(cap)
    keys = [(0, 128, True), (0, 128, False), (1, 128, True)]
    for _ in range(3):
        for k in keys:
            cache.run(k, eager, 0)
    assert cap.keys == keys
    assert [cache.run(k, eager, 5) for k in keys] == [("replay", k, 5) for k in keys]


def test_every_graph_is_kept():
    """Every batch size of the served path in both profiles on two devices,
    one after another and then again: each key captured once, never
    evicted, and every later call a replay."""
    cap = Capture()
    cache = E.GraphCache(cap)
    keys = [(d, b, p) for d in (0, 1) for p in (True, False) for b in range(1, E.GRAPH_MAX_BLOCKS + 1)]
    for _ in range(2):
        for k in keys:
            cache.run(k, eager, 0)
    before = _counts()
    assert [cache.run(k, eager, 1) for k in keys] == [("replay", k, 1) for k in keys]
    assert _counts(before) == _delta(replays=len(keys))
    assert cap.keys == keys and set(cache.graphs) == set(keys)


def test_a_raising_capture_marks_its_key_eager():
    bad, good = (0, 128, True), (0, 25, True)
    cap = Capture(refused=[bad])
    cache = E.GraphCache(cap)
    before = _counts()
    cache.run(bad, eager, 0)
    with pytest.warns(RuntimeWarning, match="capture failed"):
        assert cache.run(bad, eager, 1) == ("eager", 1)
    assert _counts(before) == _delta(eager=2, fallbacks=1)
    before = _counts()
    assert [cache.run(bad, eager, i) for i in range(2, 5)] == [("eager", i) for i in range(2, 5)]
    assert _counts(before) == _delta(eager=3)
    assert cap.keys == [bad] and cache.eager == {bad}
    for i in range(3):  # another key is not touched
        cache.run(good, eager, i)
    assert cache.run(good, eager, 9) == ("replay", good, 9)


def test_one_off_shapes_are_never_captured():
    """A key called once stays eager; it is captured when it comes again,
    however many other keys came between."""
    cap = Capture()
    cache = E.GraphCache(cap)
    for b in range(1, 101):
        cache.run((0, b, True), eager, 0)
    assert cap.keys == [] and cache.graphs == {} and len(cache.seen) == 100
    assert cache.run((0, 1, True), eager, 1) == ("replay", (0, 1, True), 1)
    assert cap.keys == [(0, 1, True)]


def test_threads_capture_each_key_once():
    """Many threads on a few keys: every call counted once, every key
    captured once, every answer its own call's."""
    cap = Capture()
    cache = E.GraphCache(cap)
    keys = [(0, b, d) for b in (1, 25, 128) for d in (True, False)]
    calls, errors = 200, []

    def worker(t):
        try:
            for i in range(calls):
                k = keys[(t + i) % len(keys)]
                got = cache.run(k, eager, (t, i))
                if got[-1] != (t, i) or (got[0] == "replay" and got[1] != k):
                    errors.append(got)
        except Exception as err:  # reported by the assertion below
            errors.append(err)

    before = _counts()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert sorted(cap.keys) == sorted(keys)
    c = _counts(before)
    assert c["encode.graph_captures"] == len(keys) and c["encode.graph_fallbacks"] == 0
    assert sum(c.values()) == 16 * calls


# ---- the served entry on the CPU ----


def _blocks(B, seed, device="cpu"):
    """B blocks: small alphabets (matches), some rows' halves repeated, some
    rows full-alphabet noise, and a few short lengths."""
    g = torch.Generator().manual_seed(seed)
    alphabet = torch.randint(2, 257, (B, 1), generator=g)
    x = (torch.rand((B, E.BS), generator=g) * alphabet).to(torch.uint8)
    half = torch.rand(B, generator=g) < 0.5
    x[half, E.BS // 2:] = x[half, : E.BS // 2]
    lens = torch.full((B,), E.BS, dtype=torch.int32)
    short = torch.rand(B, generator=g) < 0.25
    lens[short] = torch.randint(1, E.BS, (int(short.sum()),), generator=g, dtype=torch.int32)
    return x.to(device), lens.to(device)


@pytest.mark.parametrize("B, capturing, has_key", [
    (1, False, True), (25, False, True), (128, False, True),
    (0, False, False), (129, False, False), (4096, False, False), (128, True, False),
])
def test_which_cuda_calls_have_a_key(B, capturing, has_key, monkeypatch):
    """A CUDA call has a key from 1 to 128 blocks outside another capture:
    the served path's calls, so a device has at most 256 keys."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    call = SimpleNamespace(device=torch.device("cuda", 3), shape=(B, E.BS))
    assert E.graph_key(call, False) == ((3, B, False) if has_key else None)


def test_the_largest_graph_is_the_served_device_call():
    assert E.GRAPH_MAX_BLOCKS == api.DEVICE_BATCH


def test_a_cpu_tensor_never_reaches_the_cache():
    blocks, lens = _blocks(1, seed=11)
    for B in (0, 1):
        assert E.graph_key(blocks[:B], True) is None
    assert E.graph_key(torch.empty((1, E.BS), dtype=torch.uint8, device="meta"), True) is None
    state, before = _state(E._GRAPHS), _counts()
    for _ in range(3):
        rows, totals = E.encode_blocks_v2(blocks, lens, dense=False)
    want = E.encode_block_core(blocks, lens, False)
    assert torch.equal(rows, want[0]) and torch.equal(totals, want[1])
    assert _counts(before) == _delta(eager=3) and _state(E._GRAPHS) == state


@pytest.mark.parametrize("case", ["dtype", "dims", "width", "lens shape", "lens device"])
def test_check_blocks_errors_are_unchanged(case):
    blocks, lens = torch.zeros((2, E.BS), dtype=torch.uint8), torch.zeros(2, dtype=torch.int32)
    blocks, lens, match = {
        "dtype": (blocks.to(torch.int16), lens, r"blocks must be \(B, 65536\) uint8, got \(2, 65536\) torch.int16"),
        "dims": (blocks[0], lens, r"blocks must be \(B, 65536\) uint8, got \(65536,\) torch.uint8"),
        "width": (blocks[:, :100], lens, r"blocks must be \(B, 65536\) uint8, got \(2, 100\) torch.uint8"),
        "lens shape": (blocks, lens[:1], r"lens must be \(B,\) on the blocks' device"),
        "lens device": (blocks, lens.to("meta"), r"lens must be \(B,\) on the blocks' device"),
    }[case]
    state, before = _state(E._GRAPHS), _counts()
    with pytest.raises(ValueError, match=match):
        E.encode_blocks_v2(blocks, lens)
    assert _counts(before) == _delta() and _state(E._GRAPHS) == state


# ---- on a card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _same(got, want):
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fast"])
@pytest.mark.parametrize("B", [1, 25, 128])
def test_graph_equals_the_eager_chain(card, B, dense):
    """Eager, captured, then replayed calls on fresh data each, every one
    equal to `encode_block_core` on its input, rows and totals."""
    key = (card.index, B, dense)
    for i in range(4):
        blocks, lens = _blocks(B, seed=1000 * B + 10 * i + dense, device=card)
        before = _counts()
        got = E.encode_blocks_v2(blocks, lens, dense)
        c = _counts(before)
        assert _same(got, E.encode_block_core(blocks, lens, dense)), f"call {i}"
        assert sum(c.values()) == 1 and c["encode.graph_fallbacks"] == 0
    assert key in E._GRAPHS.graphs and c == _delta(replays=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fast"])
def test_interleaved_shapes_keep_their_results(card, dense):
    """Shapes in turns (128, 25, 128, 1, 25, 128), twice, on fresh data:
    their graphs share one pool, and every result returned must still hold
    its own call's answer after all the later replays."""
    before = _counts()
    shapes = (128, 25, 128, 1, 25, 128) * 2
    inputs = [_blocks(B, seed=7000 + 10 * i + dense, device=card) for i, B in enumerate(shapes)]
    got = [E.encode_blocks_v2(b, n, dense) for b, n in inputs]
    for i, ((b, n), g) in enumerate(zip(inputs, got)):
        assert _same(g, E.encode_block_core(b, n, dense)), f"call {i} (B = {shapes[i]})"
    c = _counts(before)
    assert c["encode.graph_fallbacks"] == 0 and c["encode.graph_replays"] >= len(shapes) - 6


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "fast"])
def test_a_replay_counts_the_k1_runs_of_its_graph(card, dense):
    """K1 launches in the eager call; the capture records its launches
    (`concat.recorded`), and every replay, the capturing call's too, counts
    them as `concat.graph_runs`."""
    B = 7  # a batch size no other test uses: its first call is eager
    E._GRAPHS.capture((card.index, E.GRAPH_MAX_BLOCKS, dense), None, None)  # the full batch, captured first
    names = ("concat.launches", "concat.graph_runs", "encode.eager_calls", "encode.graph_captures",
             "concat.recorded")
    steps = []
    for i in range(4):
        blocks, lens = _blocks(B, seed=9000 + 10 * i + dense, device=card)
        before = profiling.counters()
        E.encode_blocks_v2(blocks, lens, dense)
        now = profiling.counters()
        steps.append(tuple(now.get(k, 0) - before.get(k, 0) for k in names))
    k1 = steps[0][0]
    assert k1 > 0 and steps == [(k1, 0, 1, 0, 0), (0, k1, 0, 1, k1), (0, k1, 0, 0, 0), (0, k1, 0, 0, 0)]


@pytest.mark.cuda
def test_the_full_batch_is_captured_first_and_kept(card):
    """A device's first capture in a profile captures its 128-block graph
    first (the pool's largest blocks, which smaller graphs split); that
    graph answers when its own key comes, without a second capture."""
    graphs = E._CudaGraphs()
    captured = []
    capture = graphs._capture
    graphs._capture = lambda key: (captured.append(key), capture(key))[1]
    cache = E.GraphCache(graphs)
    small, full = (card.index, 3, True), (card.index, E.GRAPH_MAX_BLOCKS, True)

    def eager(b, n):
        return E.encode_block_core(b, n, True)

    for i, key in enumerate((small, small, small, full, full, full)):
        blocks, lens = _blocks(key[1], seed=9500 + i, device=card)
        assert _same(cache.run(key, eager, blocks, lens), eager(blocks, lens)), key
    assert captured == [full, small] and set(cache.graphs) == {small, full}
