"""The port's encoder tools and bench series on the CPU.

Each tool's main() runs in process with --device cpu at a small size (one
or two blocks a batch, one batch, one rep, 1 MiB, the sizes 500 and 10000)
and prints its lines; the sizes and compressed totals it reports are held
against the JAX encoder's (snappytpu.kernels.encode_v2 on the CPU) on the
same input, exactly.  CSVs go only to the test's own directory.  With
--device cuda and no card, every tool raises.
"""

import csv
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappytpu.bench import corpus as jcorpus
from snappytpu.format.varint import encode_varint
from snappytpu.kernels import encode_v2 as J
from snappytpu.stream import framing as jframing
from snappytpu_torch.bench import metrics
from snappytpu_torch.kernels import encode_v2 as E
from snappytpu_torch.tools import (bigfile_bench, dist_bench, enc_ablate, enc_profile, enc_sizes, enc_stage_fast,
                                   enc_variants, stage_profile)

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

TOOLS = {
    "stage_profile": stage_profile, "enc_profile": enc_profile, "enc_stage_fast": enc_stage_fast,
    "enc_ablate": enc_ablate, "enc_sizes": enc_sizes, "enc_variants": enc_variants, "dist_bench": dist_bench,
    "bigfile_bench": bigfile_bench,
}
NEEDS_OUT = ("enc_sizes", "dist_bench", "bigfile_bench")


def _jax_totals(datas, dense: bool) -> list:
    """The JAX encoder's compressed bytes of each input (its blocks' totals
    summed), in one call padded to 16 blocks, so every call shares one
    compile per profile."""
    packed = [jframing.pack_blocks(np.frombuffer(d, np.uint8)) for d in datas]
    blocks = np.concatenate([b for b, _l in packed])
    lens = np.concatenate([l for _b, l in packed]).astype(np.int32)
    assert blocks.shape[0] <= 16
    pad = 16 - blocks.shape[0]
    blocks = np.concatenate([blocks, np.zeros((pad, J.BS), np.uint8)])
    lens = np.concatenate([lens, np.zeros(pad, np.int32)])
    totals = np.asarray(J.encode_blocks_v2(jnp.asarray(blocks), jnp.asarray(lens), dense=dense)[1])
    cuts = np.cumsum([0] + [b.shape[0] for b, _l in packed])
    return [int(totals[a:b].sum()) for a, b in zip(cuts[:-1], cuts[1:])]


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def _rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == metrics.CSV_FIELDS
    return rows[1:]


def test_stage_profile_prints_every_stage(capsys):
    assert stage_profile.main(["--device", "cpu", "--b", "1", "--nq", "1"]) == 0
    out = _lines(capsys)
    names = ["find_matches fast", "find_matches dense", "inherit", "elect", "reglue", "emit", "encode full dense",
             "encode full fast", "decode vm (K2)"]
    for name in names:
        assert any(re.search(rf"\] {re.escape(name)} +[0-9.]+ ms/batch +[0-9.]+ MB/s$", ln) for ln in out), name
    assert out[-1].endswith("DONE")


def test_enc_profile_ratio_is_the_jax_encoders(capsys):
    assert enc_profile.main(["--device", "cpu", "--b", "2", "--nq", "1", "--cfgs", "fast:16,fast:128"]) == 0
    found = [re.search(r"encode fast: *(\d+) .* ratio ([0-9.]+)  \((\d+) bytes\)$", ln) for ln in _lines(capsys)]
    found = [m.groups() for m in found if m]
    assert [f[0] for f in found] == ["16", "128"]
    data = jcorpus.mixed(2 * J.BS, seed=100)  # the tool's batch 0 (seed 100 + q)
    (want,) = _jax_totals([data], False)
    for _nsec, ratio, nbytes in found:
        assert int(nbytes) == want
        assert ratio == f"{2 * J.BS / want:.3f}"


def test_enc_profile_presets_and_bad_configurations():
    assert set(enc_profile.PRESETS) == {"", "k12samp", "k12samp+a5", "k10samp+a6", "k14samp", "k13samp"}
    assert enc_profile.parse_cfg("dense:32:k12samp") == (True, 32, enc_variants.CONFIGS["k12samp"])
    for bad in ("dense", "slow:16", "fast:16:nope"):
        with pytest.raises((ValueError, KeyError)):
            enc_profile.parse_cfg(bad)


def test_enc_stage_fast_prints_stages_and_sorts(capsys):
    assert enc_stage_fast.main(["--device", "cpu", "--b", "1", "--nq", "1"]) == 0
    out = "\n".join(_lines(capsys))
    for name in ("find fast", "inherit", "elect", "reglue", "emit full", "emit total-only", "encode full fast",
                 "sort tierA shape", "sort tierB fast", "sort tierB-trim", "sort sortback"):
        assert re.search(rf"\] {re.escape(name)}.* [0-9.]+ ms/batch", out), name


def test_enc_stage_fast_sorts_order_as_the_encoder():
    """The timed sorts do the tiers' work: tier A's gathered key is sorted,
    tier B's gathered words follow `_lex_order`, the sort-back inverts a
    permutation."""
    sets = enc_stage_fast.sort_sets(2, 1, "cpu", seed=3)
    key, *_ = sets["A"][0]
    got = enc_stage_fast.tier_a(*sets["A"][0])
    assert torch.equal(got[0], torch.sort(key, dim=1).values)
    keys, words = sets["Btrim"][0]
    (w,) = enc_stage_fast.tier_b(keys, words)
    want = np.stack([words[0][r].numpy()[np.lexsort(tuple(k[r].numpy() for k in keys[::-1]))] for r in range(2)])
    np.testing.assert_array_equal(w.numpy(), want)
    perm, blen, bcand, pos, n = sets["back"][0]
    got = E._sort_back(perm, torch.gather(blen, 1, perm), torch.gather(bcand, 1, perm), pos, n)
    want = E._sort_back(pos.to(torch.int64), blen, bcand, pos, n)  # the identity order
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_enc_ablate_prints_nine_variants(capsys):
    assert enc_ablate.main(["--device", "cpu", "--b", "1", "--nq", "1"]) == 0
    out = _lines(capsys)
    for name in enc_ablate.VARIANTS:
        assert any(re.search(rf"\] {re.escape(name)} +[0-9.]+ ms/batch", ln) for ln in out), name
    assert len(enc_ablate.VARIANTS) == 9


def test_enc_sizes_without_reference(tmp_path, capsys):
    out_dir = tmp_path / "out"
    assert enc_sizes.main(["--device", "cpu", "--out", str(out_dir)]) == 0
    lines = _lines(capsys)
    assert "STRICT-CONTRACT: PASS" in lines
    assert os.listdir(out_dir) == ["size_margins.csv"]
    with open(out_dir / "size_margins.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["fixture", "input_size", "ref_best", "dense", "fast", "dense_margin", "fast_margin"]
    fix = {k: v for k, v in jcorpus.edge_case_corpus().items() if k != "empty"}
    assert [r[0] for r in rows[1:]] == sorted(fix)
    for name, size, ref, dense, fast, dm, fm in rows[1:]:
        assert int(ref) == -1 and int(size) == len(fix[name])
        assert int(dm) == -1 - int(dense) and int(fm) == -1 - int(fast)
    # the sizes of one-, two- and three-block fixtures are the JAX encoder's
    names = ["alice_like_text", "low_entropy_runs", "32k_ff", "one_byte"]
    sizes = {r[0]: (int(r[3]), int(r[4])) for r in rows[1:]}
    for col, dense in ((0, True), (1, False)):
        for name, total in zip(names, _jax_totals([fix[n] for n in names], dense)):
            assert sizes[name][col] == len(encode_varint(len(fix[name]))) + total, (name, dense)


def test_enc_sizes_real_dir_takes_six_files(tmp_path):
    """--real-dir adds the directory's first six files by name, those above
    1 KiB, cut to 256 KiB: the JAX tool's rule for the reference checkout's
    files, which are not in the repository, so without it no real file."""
    real = tmp_path / "real"
    real.mkdir()
    sizes = {"f0": 300_000, "f1": 1024, "f2": 2000, "f3": 1025}
    for i, (name, size) in enumerate(sizes.items()):
        (real / name).write_bytes(jcorpus.random_bytes(size, seed=i))
    for name in ("g0", "g1", "g2"):
        (real / name).write_bytes(jcorpus.text(5000, seed=7))
    (real / "sub").mkdir()  # a directory: skipped
    got = {k: v for k, v in enc_sizes.fixtures(str(real)).items() if k.startswith("real:")}
    assert sorted(got) == ["real:f0", "real:f2", "real:f3", "real:g0", "real:g1"]  # f1 has 1 KiB; g2 is seventh
    assert got["real:f0"] == jcorpus.random_bytes(300_000, seed=0)[:262144]
    assert got["real:g1"] == jcorpus.text(5000, seed=7)
    assert not [k for k in enc_sizes.fixtures() if k.startswith("real:")]


SMALL = {"one_byte": b"A", "text": jcorpus.text(3000, seed=4), "rnd": jcorpus.random_bytes(2000, seed=5)}


def _echo_binary(path):
    """A stand-in for the reference binary: it checks that it runs in its
    own directory and writes its input back, so its size is the input's."""
    path.parent.mkdir(exist_ok=True)
    path.write_text("#!/bin/sh\ntest \"$(pwd)\" = \"$(dirname \"$0\")\" || exit 3\ncp \"$2\" \"$3\"\n")
    path.chmod(0o755)
    return str(path)


def test_enc_sizes_with_a_reference_binary(tmp_path, capsys, monkeypatch):
    """--ref-cli gives `ref` and the margins; --real-dir adds the files
    above 1 KiB.  The fixtures are cut to three small ones."""
    monkeypatch.setattr(enc_sizes.corpus, "edge_case_corpus", lambda: dict(SMALL, empty=b""))
    exe = _echo_binary(tmp_path / "bin" / "snappy")
    real = tmp_path / "real"
    real.mkdir()
    (real / "a.txt").write_bytes(jcorpus.text(3000, seed=6))
    (real / "tiny").write_bytes(b"x" * 100)  # 1 KiB or less: left out
    out_dir = tmp_path / "out"
    assert enc_sizes.main(["--device", "cpu", "--out", str(out_dir), "--ref-cli", exe, "--real-dir", str(real)]) == 0
    lines = _lines(capsys)
    assert [ln.split()[1] for ln in lines[:-2]] == ["one_byte", "real:a.txt", "rnd", "text"]
    ok = {ln.split()[1]: ln.split()[0] for ln in lines[:-2]}
    assert ok == {"one_byte": "FAIL", "real:a.txt": "OK", "rnd": "FAIL", "text": "OK"}  # 1 byte and random expand
    assert " ref     3000 " in lines[1] and lines[-2] == "STRICT-CONTRACT: 2 FAIL"
    with open(out_dir / "size_margins.csv") as f:
        rows = {r[0]: r for r in csv.reader(f)}
    assert rows["text"][2] == "3000" and int(rows["text"][5]) == 3000 - int(rows["text"][3])


def test_enc_variants_sizes_alone_and_against_a_reference(tmp_path, capsys, monkeypatch):
    assert enc_variants.main(["--device", "cpu", "--configs", "base16"]) == 0
    (line,) = _lines(capsys)
    sizes = dict(tok.rsplit(":", 1) for tok in line.split()[1:])
    fix = enc_sizes.fixtures()
    assert line.split()[0] == "base16" and set(sizes) == set(fix)
    names = ("alice_like_text", "two_blocks_mixed", "one_byte")
    for name, total in zip(names, _jax_totals([fix[n] for n in names], True)):
        assert int(sizes[name]) == len(encode_varint(len(fix[name]))) + total
    monkeypatch.setattr(enc_sizes.corpus, "edge_case_corpus", lambda: dict(SMALL))
    exe = _echo_binary(tmp_path / "bin" / "snappy")
    assert enc_variants.main(["--device", "cpu", "--configs", "k8,base16", "--ref-cli", exe]) == 0
    lines = _lines(capsys)
    want = len(SMALL["rnd"]) - enc_variants.dense_size(SMALL["rnd"], "cpu")
    assert [ln.split()[:2] for ln in lines] == [["FAIL", "base16"], ["FAIL", "k8"]]  # CONFIGS' order
    assert lines[0] == f"FAIL base16       worst rnd:{want:+d} | one_byte:-2 rnd:{want:+d}"  # margins under 200
    with pytest.raises(ValueError, match="unknown"):
        enc_variants.main(["--device", "cpu", "--configs", "nope"])


def test_dist_bench_rows(tmp_path, capsys):
    out_dir = tmp_path / "dist"
    assert dist_bench.main(["--device", "cpu", "--out", str(out_dir), "--sizes", "500,10000", "--cpu-reps", "1",
                            "--dev-reps", "1", "--profiles", "fast"]) == 0
    assert _lines(capsys)[-1].endswith("DONE")
    assert sorted(os.listdir(out_dir)) == [
        "compression_results_cpu_hash_dist.csv", "compression_results_device_fast_dist.csv",
        "decompression_results_cpu_hash_dist.csv", "decompression_results_device_fast_dist.csv"]
    comp = _rows(out_dir / "compression_results_device_fast_dist.csv")
    dec = _rows(out_dir / "decompression_results_device_fast_dist.csv")
    wants = _jax_totals([jcorpus.mixed(size, seed=size % 97) for size in (500, 10000)], False)
    for size, want, crow, drow in zip((500, 10000), wants, comp, dec):
        assert crow[:2] == [str(size), str(want)] and crow[-2:] == ["compress", "cpu"]
        assert drow[:2] == [str(want), str(size)] and drow[-2:] == ["decompress", "cpu"]
    for row in _rows(out_dir / "compression_results_cpu_hash_dist.csv"):
        assert row[-2:] == ["compress", "cpu"]


def test_bigfile_bench_rows_and_round_trip(tmp_path, capsys):
    out_dir = tmp_path / "big"
    assert bigfile_bench.main(["--device", "cpu", "--out", str(out_dir), "--mb", "1", "--profiles", "fast"]) == 0
    out = "\n".join(_lines(capsys))
    assert "blocks exact 16/16" in out
    assert sorted(os.listdir(out_dir)) == ["compression_results_device_fast.csv",
                                           "decompression_results_device_fast.csv"]
    data = jcorpus.mixed(1 << 20, seed=99)  # the JAX tool's input without the reference checkout
    (want,) = _jax_totals([data], False)
    (crow,) = _rows(out_dir / "compression_results_device_fast.csv")
    (drow,) = _rows(out_dir / "decompression_results_device_fast.csv")
    assert crow[:2] == [str(1 << 20), str(want)] and crow[-2:] == ["compress", "cpu"]
    assert drow[:2] == [str(want), str(1 << 20)] and drow[-2:] == ["decompress", "cpu"]


def test_bigfile_bench_reads_the_silesia_standin(tmp_path, monkeypatch):
    """Its input is corpus.silesia_standin(MB << 20), cut to MB << 20."""
    calls = []

    def standin(n):
        calls.append(n)
        return jcorpus.mixed(n, seed=5) + b"past the end"

    monkeypatch.setattr(bigfile_bench.corpus, "silesia_standin", standin)
    out_dir = tmp_path / "big"
    assert bigfile_bench.main(["--device", "cpu", "--out", str(out_dir), "--mb", "1", "--profiles", "fast"]) == 0
    assert calls == [1 << 20]
    (crow,) = _rows(out_dir / "compression_results_device_fast.csv")
    (drow,) = _rows(out_dir / "decompression_results_device_fast.csv")
    assert crow[0] == drow[1] == str(1 << 20)


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_cuda_without_a_card_raises(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--device", "cuda"] + (["--out", str(tmp_path / "never")] if name in NEEDS_OUT else [])
    with pytest.raises(RuntimeError, match="is_available"):
        TOOLS[name].main(argv)
    assert not (tmp_path / "never").exists()
