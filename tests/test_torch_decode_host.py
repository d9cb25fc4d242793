"""K2's accept set, checked from the kernel's own source without a GPU.

snappytpu_torch/csrc/decode_block.cuh holds the op parser, its validation
and the decode loop as host+device code.  Here g++ builds it into a tiny
host harness whose mover uses the kernel's parallel copy indexing
(out[opc + j] = out[opc - dist + j % dist]), and the harness is held against
the plain version and the JAX decoder on the rows of test_torch_decode.py,
plus a larger seeded mutation fuzz against the plain version.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from snappytpu.format import constants as C
from snappytpu_torch import _build
from snappytpu_torch.kernels import decode_vm4
from test_torch_decode import FAMILIES, _rows, decoded, golden_streams, own_streams

HARNESS = r"""
#include <string.h>
#include "decode_block.cuh"

namespace {
struct HostMover {
  const uint8_t* comp;
  uint8_t* out;
  void literal(int64_t opc, int64_t src, int64_t len) { memcpy(out + opc, comp + src, len); }
  void copy(int64_t opc, int64_t dist, int64_t len) {
    const uint8_t* from = out + opc - dist;
    for (int64_t j = 0; j < len; ++j) out[opc + j] = from[dist >= len ? j : j % dist];
  }
};
}  // namespace

extern "C" int decode_block_host(const uint8_t* row, int64_t comp_len, int64_t out_len, uint8_t* out) {
  memset(out, 0, snappy_block::kBlockSize);
  HostMover mv{row, out};
  return snappy_block::decode_block(row, comp_len, out_len, mv) ? 1 : 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("decode_host")
    src, lib = d / "harness.cc", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-o", str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).decode_block_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(rows, cl, ol):
        rows = np.ascontiguousarray(rows)
        out = np.empty((rows.shape[0], C.MAX_BLOCK_SIZE), np.uint8)
        ok = np.array([fn(rows[i].ctypes.data, int(cl[i]), int(ol[i]), out[i].ctypes.data)
                       for i in range(rows.shape[0])], bool)
        return out, ok

    return run


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_host_build_equals_jax_and_plain(harness, family):
    rows, cl, ol, jout, jok = decoded(family)
    out, ok = harness(rows, cl, ol)
    pout, pok = decode_vm4.decode_blocks_ref(torch.from_numpy(rows), torch.from_numpy(cl), torch.from_numpy(ol))
    np.testing.assert_array_equal(ok, jok, err_msg="ok vs JAX")
    np.testing.assert_array_equal(ok, pok.numpy(), err_msg="ok vs plain")
    np.testing.assert_array_equal(out[ok], jout[ok], err_msg="rows vs JAX")
    np.testing.assert_array_equal(out, pout.numpy(), err_msg="rows vs plain")


@pytest.mark.parametrize("seed", range(4))
def test_host_build_equals_plain_on_mutation_fuzz(harness, seed):
    """400 more seeded mutations per seed, of header and payload bytes alike;
    flags must agree everywhere and rows wherever ok."""
    rng = np.random.default_rng(500 + seed)
    base = own_streams() + golden_streams()
    streams = []
    for _ in range(400):
        ops, n = base[int(rng.integers(0, len(base)))]
        arr = bytearray(ops)
        for _ in range(int(rng.integers(1, 4))):
            arr[int(rng.integers(0, len(arr)))] = int(rng.integers(0, 256))
        cut = len(arr) if rng.random() < 0.8 else int(rng.integers(0, len(arr) + 1))
        streams.append((bytes(arr[:cut]), n if rng.random() < 0.9 else int(rng.integers(0, C.MAX_BLOCK_SIZE + 1))))
    rows, cl, ol = _rows(streams)
    out, ok = harness(rows, cl, ol)
    pout, pok = decode_vm4.decode_blocks_ref(torch.from_numpy(rows), torch.from_numpy(cl), torch.from_numpy(ol))
    np.testing.assert_array_equal(ok, pok.numpy())
    np.testing.assert_array_equal(out[ok], pout.numpy()[ok])
    assert 0 < ok.sum() < ok.size
