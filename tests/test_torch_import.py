"""The PyTorch port stands alone: it imports and runs without JAX (the GPU
host has none) and without the JAX package snappytpu, whose JAX-free layers
it keeps as its own copies.  The scan covers the package, chip_smoke.py and
the distributed test's worker process."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import numpy as np
import torch
import snappytpu_torch
from snappytpu_torch import _build, api, cli, config, cpu, entry, format, mesh, model, profiling
from snappytpu_torch.bench import corpus, metrics, run, sweep
from snappytpu_torch.format import constants, varint
from snappytpu_torch.format.varint import encode_varint
from snappytpu_torch.kernels import concat, decode_tape, decode_vm, decode_vm2, decode_vm4, encode_v2
from snappytpu_torch.kernels import decode_jax, encode_jax, pipeline
from snappytpu_torch.model import decode, encode, encode_v2_spec
from snappytpu_torch.mesh import sharding
from snappytpu_torch.stream import filecodec, framing, manifest
from snappytpu_torch.tools import _staged, config4_mesh, dec_anatomy, dec_profile, probe_scalar, tape_probe
from snappytpu_torch.tools import (bigfile_bench, dist_bench, enc_ablate, enc_profile, enc_sizes, enc_stage_fast,
                                   enc_variants, stage_profile)

data = corpus.mixed(70_000, seed=3)
for profile in ("fast", "dense"):
    stream = api.compress(data, profile, device="cpu")
    assert api.decompress(stream, device="cpu") == data
# an unaligned stream: its ops straddle the 64 KiB grid (the windowed route)
tail = np.frombuffer(api.compress(data[5:], "fast", device="cpu"), np.uint8)
stream = encode_varint(len(data)) + bytes([4 << 2]) + data[:5] + tail[3:].tobytes()
assert api.decompress(stream, device="cpu") == data
# the native runtime's routes and the model codec
assert cpu.available
assert cpu.decompress(cpu.compress(data)) == data
assert model.decompress(model.compress(data[:3000])) == data[:3000]
# the mesh, the entry points and the benchmark runner on the CPU
m = mesh.make_mesh(2, "cpu")
blocks, lens = framing.pack_blocks(np.frombuffer(data, np.uint8))
comp, totals = mesh.encode_mesh(m, blocks, lens, "fast")
assert encode_varint(len(data)) + cpu.compact(comp, totals) == api.compress(data, "fast", device="cpu")
entry.dryrun_multichip(2, device="cpu")
# the research codecs, the spec and the mesh's sharded calls
tb, tl = (torch.from_numpy(a[:2]) for a in (blocks, lens))
rtot = {}
for profile in config.PROFILES:
    rc, rt = rtot[profile] = pipeline.encode_pipeline(tb, tl, profile)
    rows, rcl = framing.pad_chunks([rc[i, : rt[i]].numpy() for i in range(2)])
    out, ok = pipeline.decode_pipeline(torch.from_numpy(rows), torch.from_numpy(rcl), tl)
    assert bool(ok.all()) and torch.equal(out, tb)
assert all(torch.equal(a, b) for a, b in zip(encode_jax.encode_blocks(tb, tl), rtot["dense"]))
s_comp, s_tot = mesh.sharded_encode(m, False)([tb[:1], tb[1:]], [tl[:1], tl[1:]])
assert np.array_equal(torch.cat(s_comp).numpy(), comp[:2]) and np.array_equal(torch.cat(s_tot).numpy(), totals[:2])
spec_bytes, _ = encode_v2_spec.spec_encode_block(blocks[0], 3000)
assert run.measure("mixed", 1, 1, device="cpu")["backend"] == "cpu"
# the encoder's knobs and an encoder tool
blocks1, lens1 = (torch.from_numpy(a[:1]) for a in framing.pack_blocks(np.frombuffer(data, np.uint8)))
rows64, t64 = encode_v2.encode_block_core(blocks1, lens1, True)
rows16, t16 = encode_v2.encode_block_core(blocks1, lens1, True, nsec=16, dense_keys=tuple(range(16)))
assert torch.equal(rows64, rows16) and torch.equal(t64, t16)
assert enc_ablate.main(["--device", "cpu", "--b", "1", "--nq", "1"]) == 0
# the profiling tools' plain routes
p = probe_scalar.Probe("smem_chase")
tile, _ = probe_scalar.run(p, torch.from_numpy(probe_scalar.inputs(p)), 50)
timer = profiling.StageTimer()
with timer.stage("probe", tile):
    pass
assert "probe" in timer.report()
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]
assert not bad, bad
bad = [m for m in sys.modules if m == "snappytpu" or m.startswith("snappytpu.")]
assert not bad, bad
print("ok")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_build_is_lazy():
    """Importing the kernels and the tools builds nothing: no nvcc is needed
    on the CPU."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    probe = ("import snappytpu_torch.kernels, snappytpu_torch._build as b, sys;"
             "import snappytpu_torch.mesh, snappytpu_torch.entry, snappytpu_torch.bench.run, snappytpu_torch.bench.sweep;"
             "import snappytpu_torch.stream.manifest, snappytpu_torch.tools.config4_mesh;"
             "import snappytpu_torch.tools.dec_profile, snappytpu_torch.tools.dec_anatomy;"
             "import snappytpu_torch.tools.tape_probe, snappytpu_torch.tools.probe_scalar;"
             "import snappytpu_torch.tools.stage_profile, snappytpu_torch.tools.enc_profile;"
             "import snappytpu_torch.tools.enc_stage_fast, snappytpu_torch.tools.enc_ablate;"
             "import snappytpu_torch.tools.enc_sizes, snappytpu_torch.tools.enc_variants;"
             "import snappytpu_torch.tools.dist_bench, snappytpu_torch.tools.bigfile_bench;"
             "import snappytpu_torch.config, snappytpu_torch.kernels.pipeline, snappytpu_torch.model.encode_v2_spec;"
             "assert b.library.cache_info().currsize == 0;"
             "assert 'torch.utils.cpp_extension' not in sys.modules; print('ok')")
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]


def _port_sources():
    root = Path(ROOT)
    return sorted((root / "snappytpu_torch").rglob("*.py")) + [root / "chip_smoke.py",
                                                               root / "tests" / "torch_distributed_worker.py"]


def _imports_of_snappytpu(path: Path):
    """Every import statement in the file, at any depth (inside functions
    too), that names the JAX package snappytpu or a module of it."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [f"{path.name}:{node.lineno} {n}" for n in names
                  if n == "snappytpu" or n.startswith("snappytpu.") or n == "jax" or n.startswith(("jax.", "jaxlib"))]
    return found


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_the_jax_package(path):
    assert _imports_of_snappytpu(path) == []


def test_the_import_scan_sees_nested_imports(tmp_path):
    """The scan finds the forms it must refuse, also inside a function."""
    src = tmp_path / "probe.py"
    src.write_text("import snappytpu\nfrom snappytpu.cpu import x\ndef f():\n    from snappytpu import cpu\n"
                   "    import snappytpu.format.varint as v\nfrom snappytpu_torch import cpu\nfrom . import y\n")
    assert [f.split()[1] for f in _imports_of_snappytpu(src)] == [
        "snappytpu", "snappytpu.cpu", "snappytpu", "snappytpu.format.varint"]
