"""The port's benchmark runner (snappytpu_torch.bench.run) on the CPU at
1 MB with one rep: bench.py's JSON keys (the port's set) on the mixed
corpus and on the default Silesia stand-in with its mixed32 companion, the
round trip it verifies, its ratios equal to the port API's streams (and so
to the JAX package's), and no fallback to the CPU without a card."""

import io
import json
import sys

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
    line.  SNAPPYTPU_BENCH_CORPUS=mixed: the default is the 128 MB stand-in."""
    mp = pytest.MonkeyPatch()
    out = io.StringIO()
    try:
        for k, v in (("SNAPPYTPU_BENCH_MB", "1"), ("SNAPPYTPU_BENCH_REPS", "1"), ("SNAPPYTPU_BENCH_CORPUS", "mixed")):
            mp.setenv(k, v)
        mp.delenv("SNAPPYTPU_BENCH_DENSE", raising=False)
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


def test_default_device_raises_without_a_card(monkeypatch):
    """At once: no corpus is built first."""
    def never(*a, **k):
        raise AssertionError("a corpus was built before the device check")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("mixed", "silesia_standin"):
        monkeypatch.setattr(corpus, name, never)
    monkeypatch.delenv("SNAPPYTPU_BENCH_CORPUS", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run.measure("mixed", 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run.main([])


def test_unknown_corpus_is_refused():
    with pytest.raises(ValueError, match="'silesia' and 'mixed'"):
        run.measure("calgary", 1, 1, device="cpu")


@pytest.fixture(scope="module")
def silesia():
    """main() at its defaults but SNAPPYTPU_BENCH_MB=1, SNAPPYTPU_BENCH_REPS=1
    and a 1 MB companion, on the CPU: (its last stdout line, its stderr)."""
    mp = pytest.MonkeyPatch()
    out, err = io.StringIO(), io.StringIO()
    try:
        for k, v in (("SNAPPYTPU_BENCH_MB", "1"), ("SNAPPYTPU_BENCH_REPS", "1")):
            mp.setenv(k, v)
        for k in ("SNAPPYTPU_BENCH_DENSE", "SNAPPYTPU_BENCH_CORPUS", "SNAPPYTPU_BENCH_COMPANION32"):
            mp.delenv(k, raising=False)
        mp.setattr(run, "COMPANION_MB", 1)
        mp.setattr("sys.stdout", out)
        mp.setattr("sys.stderr", err)
        assert run.main(["--device", "cpu"]) == 0
    finally:
        mp.undo()
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def _bench_py_line(monkeypatch, tmp_path) -> dict:
    """bench.py's main() at its silesia default with _measure giving fixed
    numbers and its refhost summary out of reach: its JSON line."""
    for k in ("JAX_COMPILATION_CACHE_DIR", "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS",
              "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"):
        monkeypatch.setenv(k, "unused")  # bench.py's import-time setdefaults change nothing
    monkeypatch.delenv("SNAPPYTPU_BENCH_COMPANION32", raising=False)
    import bench  # the repo root, on the path by conftest.py

    fixed = {k: 1.0 for k in ("value", "vs_baseline", "encode_gbps", "decode_gbps", "ratio", "companion_encode_gbps",
                              "companion_ratio")}
    monkeypatch.setattr(bench, "_measure", lambda *a: dict(fixed, backend="tpu"))
    monkeypatch.setattr(bench, "__file__", str(tmp_path / "bench.py"))
    monkeypatch.setattr(bench, "WHICH", "silesia")
    monkeypatch.setattr(bench, "BENCH_MB", 1)
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    bench.main()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_silesia_keys_are_bench_py_s(silesia, monkeypatch, tmp_path):
    """bench.py's line less the host-reference keys, with device_name after
    backend, in bench.py's order."""
    line, _err = silesia
    want = [k for k in _bench_py_line(monkeypatch, tmp_path) if k not in ("vs_host_reference", "host_reference_mbps")]
    want.insert(want.index("backend") + 1, "device_name")
    assert list(line) == want == list(run.SILESIA_KEYS)
    assert list(run.SILESIA_KEYS[len(run.KEYS):]) == [k for k in want if k.startswith("mixed32_")]


def test_silesia_line(silesia):
    line, err = silesia
    assert line["metric"] == "encode+decode GB/s per chip (1 MB silesia stand-in: synthetic mixed, seed 99, round-trip verified)"
    assert (line["corpus"], line["input_mb"], line["backend"], line["reps"]) == ("silesia", 1, "cpu", 1)
    assert "the silesia stand-in is synthetic: the mixed corpus, seed 99" in err
    assert "companion run: 1 MB mixed corpus" in err
    for k in ("mixed32_gbps", "mixed32_encode_gbps", "mixed32_decode_gbps", "mixed32_vs_baseline"):
        assert line[k] > 0, k


@pytest.mark.parametrize("key,data", [
    ("ratio", lambda: corpus.mixed(1 << 20, seed=99)),  # the stand-in
    ("mixed32_ratio", lambda: corpus.mixed(1 << 20, seed=42)),
])
def test_silesia_ratios_equal_the_api_stream(silesia, key, data):
    data = data()
    stream = api.compress(data, "fast", device="cpu")
    assert silesia[0][key] == round(len(data) / (len(stream) - len(encode_varint(len(data)))), 4)


@pytest.mark.parametrize("companion,calls", [
    (None, [("silesia", 128, 5, False), ("mixed", 32, 5, False)]),
    ("1", [("silesia", 128, 5, False), ("mixed", 32, 5, False)]),
    ("0", [("silesia", 128, 5, False)]),
])
def test_silesia_defaults_and_companion(monkeypatch, companion, calls):
    """No SNAPPYTPU_BENCH_* variable: the 128 MB stand-in, then the 32 MB
    mixed companion, whose numbers follow KEYS as the mixed32_* keys;
    SNAPPYTPU_BENCH_COMPANION32=0 leaves the companion out."""
    seen = []

    def fake(which, mb, reps, dense, device):
        seen.append((which, mb, reps, dense))
        return {k: (f"{which}:{k}" if k != "value" else mb) for k in run.KEYS}

    for k in ("SNAPPYTPU_BENCH_MB", "SNAPPYTPU_BENCH_REPS", "SNAPPYTPU_BENCH_DENSE", "SNAPPYTPU_BENCH_CORPUS"):
        monkeypatch.delenv(k, raising=False)
    if companion is None:
        monkeypatch.delenv("SNAPPYTPU_BENCH_COMPANION32", raising=False)
    else:
        monkeypatch.setenv("SNAPPYTPU_BENCH_COMPANION32", companion)
    monkeypatch.setattr(run, "measure", fake)
    out = io.StringIO()
    monkeypatch.setattr("sys.stdout", out)
    run.main(["--device", "cpu"])
    line = json.loads(out.getvalue().splitlines()[-1])
    assert seen == calls
    if len(calls) == 1:
        assert tuple(line) == run.KEYS
        return
    assert tuple(line) == run.SILESIA_KEYS and line["value"] == 128 and line["metric"] == "silesia:metric"
    assert [line[k] for k in run.MIXED32_KEYS] == [32, "mixed:vs_baseline", "mixed:encode_gbps", "mixed:decode_gbps",
                                                    "mixed:ratio"]

