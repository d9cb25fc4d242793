"""The PyTorch port imports and runs without JAX: its package must never
pull in jax (the GPU host has none), only the JAX-free layers of snappytpu."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import numpy as np
import snappytpu_torch
from snappytpu_torch import api, cli
from snappytpu_torch.kernels import concat, decode_tape, decode_vm, decode_vm2, decode_vm4, encode_v2
from snappytpu_torch.stream import filecodec
from snappytpu.bench import corpus
from snappytpu.format.varint import encode_varint

data = corpus.mixed(70_000, seed=3)
for profile in ("fast", "dense"):
    stream = api.compress(data, profile, device="cpu")
    assert api.decompress(stream, device="cpu") == data
# an unaligned stream: its ops straddle the 64 KiB grid (the windowed route)
tail = np.frombuffer(api.compress(data[5:], "fast", device="cpu"), np.uint8)
stream = encode_varint(len(data)) + bytes([4 << 2]) + data[:5] + tail[3:].tobytes()
assert api.decompress(stream, device="cpu") == data
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]
assert not bad, bad
assert not any(m.startswith(("snappytpu.kernels", "snappytpu.api", "snappytpu.mesh", "snappytpu.profiling"))
               for m in sys.modules)
print("ok")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_build_is_lazy():
    """Importing the kernels builds nothing: no nvcc is needed on the CPU."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    probe = ("import snappytpu_torch.kernels, snappytpu_torch._build as b, sys;"
             "assert b.library.cache_info().currsize == 0;"
             "assert 'torch.utils.cpp_extension' not in sys.modules; print('ok')")
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
