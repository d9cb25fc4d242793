"""The port's profiling module and the tools' staged-input harness on the
CPU: StageTimer's report against the JAX package's StageTimer for the same
stage sequence, the torch.profiler trace, `timed`, `load_staged` on a cache
file written in the JAX tools' format, and dec_profile's plain run."""

import os
import re
import time

import numpy as np
import pytest
import torch

from snappytpu import profiling as jax_profiling
from snappytpu_torch import cpu as port_cpu
from snappytpu_torch import profiling
from snappytpu_torch.kernels import decode_vm4
from snappytpu_torch.tools import _staged, dec_profile

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side


def _rows(report: str):
    """(stage, calls) of each row of a StageTimer report, in its order."""
    rows = []
    for line in report.splitlines()[1:]:
        m = re.match(r"^(\S+)\s+(\d+)?\s+[\d.]+", line)
        rows.append((m.group(1), m.group(2) and int(m.group(2))))
    return rows


def test_stage_timer_report_matches_jax():
    # stage durations far apart, so that both timers sort the rows alike
    seq = [("parse", 0.030), ("move", 0.001), ("parse", 0.030), ("flush", 0.010), ("move", 0.001)]
    timers = (profiling.StageTimer(), jax_profiling.StageTimer())
    x = torch.zeros(4)
    for name, secs in seq:
        for t in timers:
            with t.stage(name, x):
                time.sleep(secs)
    port_report, jax_report = (t.report() for t in timers)
    assert port_report.splitlines()[0] == jax_report.splitlines()[0]
    assert _rows(port_report) == _rows(jax_report) == [("parse", 2), ("flush", 1), ("move", 2), ("TOTAL", None)]
    assert dict(timers[0].counts) == dict(timers[1].counts)


def test_stage_timer_disabled_and_empty():
    t = profiling.StageTimer(enabled=False)
    with t.stage("x"):
        pass
    assert t.report() == jax_profiling.StageTimer().report() == "(no stages recorded)"


def test_timed_and_device_trace(tmp_path):
    a = torch.arange(1000.0)
    out, secs = profiling.timed(torch.cumsum, a, 0, reps=3, warmup=1)
    assert torch.equal(out, torch.cumsum(a, 0)) and secs > 0
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.cumsum(a, 0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("cumsum" in e.key for e in prof.key_averages())


def test_load_staged_reads_the_jax_tools_cache(tmp_path):
    """A cache file as tools/dec_profile.py writes it (np.savez_compressed
    of comp, totals, lens) loads into the port's tensors and decodes."""
    from snappytpu.bench import corpus
    from snappytpu.format import constants as C
    from snappytpu.kernels.encode_v2 import encode_blocks_v2 as jax_encode
    from snappytpu.stream import framing

    data = np.frombuffer(corpus.text(2 * C.MAX_BLOCK_SIZE, seed=300), np.uint8)
    blocks, lens = framing.pack_blocks(data)
    comp, totals = jax_encode(blocks[:2], lens[:2], True)
    path = tmp_path / "decprof_abc-dense_text_0_2.npz"
    np.savez_compressed(path, comp=np.asarray(comp), totals=np.asarray(totals), lens=np.asarray(lens[:2], np.int32))
    c, t, n = _staged.load_staged(path)
    assert c.dtype == torch.uint8 and c.shape == (2, C.MAX_COMPRESSED_BLOCK_SIZE)
    assert t.dtype == n.dtype == torch.int32 and n.tolist() == [C.MAX_BLOCK_SIZE] * 2
    out, ok = decode_vm4.decode_blocks_vm4(c, t, n)
    assert ok.all() and out.numpy().tobytes() == data.tobytes()


def test_dec_profile_plain_run(tmp_path, monkeypatch, capsys):
    """dec_profile on the CPU: two 2-block sets per corpus, encoded by the
    port and cached under the temporary directory, then the second run reads
    the cache."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    vms = ["4", "tape"] if port_cpu.available else ["4"]
    for vm in vms:
        assert dec_profile.main(["--b", "2", "--nq", "2", "--corpus", "text,nope", "--vm", vm, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("ms/batch") == len(vms) and "skip nope" in out
    assert sorted(os.listdir(tmp_path)) == [f"decprof_{_staged.cache_tag()}_text_{q}_2.npz" for q in range(2)]


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        _staged.device_of("cuda")
