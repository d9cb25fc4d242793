"""The port's benchmark runner (snappytpu_torch.bench.run) on the CPU at
1 MB with one rep: bench.py's JSON keys (the port's set), the round trip it
verifies, its ratios equal to the port API's streams (and so to the JAX
package's), silesia refused, and no fallback to the CPU without a card."""

import io
import json

import pytest
import torch

from snappytpu_torch import api
from snappytpu_torch.bench import corpus, run
from snappytpu_torch.format.varint import encode_varint

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side


@pytest.fixture(scope="module")
def result():
    """main() as `python -m snappytpu_torch.bench.run --device cpu` runs it,
    with SNAPPYTPU_BENCH_MB=1 and SNAPPYTPU_BENCH_REPS=1: its last stdout
    line."""
    mp = pytest.MonkeyPatch()
    out = io.StringIO()
    try:
        for k, v in (("SNAPPYTPU_BENCH_MB", "1"), ("SNAPPYTPU_BENCH_REPS", "1")):
            mp.setenv(k, v)
        mp.delenv("SNAPPYTPU_BENCH_DENSE", raising=False)
        mp.delenv("SNAPPYTPU_BENCH_CORPUS", raising=False)
        mp.setattr("sys.stdout", out)
        assert run.main(["--device", "cpu"]) == 0
    finally:
        mp.undo()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_keys_and_labels(result):
    assert tuple(result) == run.KEYS
    assert result["unit"] == "GB/s" and result["corpus"] == "mixed" and result["input_mb"] == 1
    assert (result["profile"], result["companion_profile"]) == ("fast", "dense")
    assert (result["backend"], result["device_name"], result["reps"]) == ("cpu", "cpu", 1)


def test_numbers_are_consistent(result):
    for k in ("value", "encode_gbps", "decode_gbps", "companion_encode_gbps"):
        assert result[k] > 0, k
    # each number was rounded to 4 decimals (2 for vs_baseline) from unrounded times
    enc, dec = result["encode_gbps"], result["decode_gbps"]
    lo, hi = 1 / (1 / (enc - 5e-5) + 1 / (dec - 5e-5)), 1 / (1 / (enc + 5e-5) + 1 / (dec + 5e-5))
    assert lo - 5e-5 <= result["value"] <= hi + 5e-5
    assert abs(result["vs_baseline"] - result["value"] * 1000 / 40.9) <= 0.005 + 5e-5 * 1000 / 40.9


@pytest.mark.parametrize("profile,key", [("fast", "ratio"), ("dense", "companion_ratio")])
def test_ratio_equals_the_api_stream(result, profile, key):
    data = corpus.mixed(1 << 20, seed=42)
    stream = api.compress(data, profile, device="cpu")
    assert result[key] == round(len(data) / (len(stream) - len(encode_varint(len(data)))), 4)


def test_environment_reaches_the_measurement(monkeypatch):
    """SNAPPYTPU_BENCH_DENSE=1 makes dense the headline; _MB, _REPS and
    _CORPUS reach measure(), whose object is the JSON line."""
    calls = []
    line = {k: i for i, k in enumerate(run.KEYS)}

    def fake(*a, **k):
        calls.append((a, k))
        return line

    monkeypatch.setattr(run, "measure", fake)
    for k, v in (("SNAPPYTPU_BENCH_DENSE", "1"), ("SNAPPYTPU_BENCH_MB", "3"), ("SNAPPYTPU_BENCH_REPS", "2"),
                 ("SNAPPYTPU_BENCH_CORPUS", "mixed")):
        monkeypatch.setenv(k, v)
    out = io.StringIO()
    monkeypatch.setattr("sys.stdout", out)
    run.main(["--device", "cpu"])
    assert calls == [(("mixed", 3, 2, True), {"device": "cpu"})]
    assert json.loads(out.getvalue().splitlines()[-1]) == line


def test_dense_headline_labels(monkeypatch):
    """With dense as the headline the labels swap and each ratio follows its
    profile (a stand-in codec: the rows are the blocks, and dense halves the
    totals)."""
    from snappytpu_torch.kernels import decode_vm, encode_v2

    monkeypatch.setattr(encode_v2, "encode_block_core", lambda b, n, dense: (b.clone(), n // (2 if dense else 1)))
    monkeypatch.setattr(decode_vm, "decode_blocks_vm", lambda c, t, n: (c, torch.ones(c.shape[0], dtype=torch.bool)))
    r = run.measure("mixed", 1, 1, dense=True, device="cpu")
    assert tuple(r) == run.KEYS
    assert (r["profile"], r["companion_profile"], r["ratio"], r["companion_ratio"]) == ("dense", "fast", 2.0, 1.0)
    assert (r["input_mb"], r["reps"], r["corpus"]) == (1, 1, "mixed")


def test_round_trip_is_verified(monkeypatch):
    """A decoder that returns a wrong byte fails the run, as bench.py's
    device-side block comparison does."""
    from snappytpu_torch.kernels import decode_vm

    real = decode_vm.decode_blocks_vm

    def broken(c, t, n):
        out, ok = real(c, t, n)
        out = out.clone()
        out[0, 5] ^= 1
        return out, ok

    monkeypatch.setattr(decode_vm, "decode_blocks_vm", broken)
    with pytest.raises(AssertionError, match="round trip mismatch on 1 blocks"):
        run.measure("mixed", 1, 1, device="cpu")


def test_silesia_is_refused():
    with pytest.raises(ValueError, match="F2"):
        run.measure("silesia", 1, 1, device="cpu")


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run.measure("mixed", 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run.main([])

