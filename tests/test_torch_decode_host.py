"""The kernels' shared headers, checked from their own source without a GPU.

snappytpu_torch/csrc/decode_block.cuh holds the op parser, its validation
and the decode loop (K2, K3, K4); decode_tape.cuh holds the tape record
format and how a warp's lanes move a record (K5, K6).  Both are host+device
code.  Here g++ builds them into a tiny host harness:
  * K2: a mover with the kernel's parallel copy indexing
    (out[opc + j] = out[opc - dist + j % dist]), held against the plain
    version and the JAX decoder on the rows of test_torch_decode.py, plus a
    seeded mutation fuzz against the plain version;
  * K4: the parser with ctx_len > 0 over the kernel's 128 KiB ring, held
    against the plain windowed decoder;
  * K5: the tape walk with the kernel's lane indexing (32 lanes emulated
    in reverse order; fills index j % p), held against the plain _run_tape.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from snappytpu import cpu
from snappytpu.format import constants as C
from snappytpu.stream import framing
from snappytpu_torch import _build
from snappytpu_torch.kernels import decode_tape, decode_vm2, decode_vm4
from test_fuzz_decode import _unaligned_stream
from test_stream_decode import _build_straddling_stream, _copy4, _lit
from test_torch_decode import FAMILIES, _rows, decoded, golden_streams, own_streams

HARNESS = r"""
#include <string.h>
#include "decode_block.cuh"
#include "decode_tape.cuh"

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
  return snappy_block::decode_block(row, comp_len, out_len, 0, mv) ? 1 : 0;
}

namespace {
constexpr int64_t kRing = 2 * snappy_block::kBlockSize;
struct RingMover {  // decode_stream.cu's addressing, one byte at a time
  const uint8_t* comp;
  uint8_t* ring;
  int64_t base;
  void literal(int64_t opc, int64_t src, int64_t len) {
    for (int64_t j = 0; j < len; ++j) ring[(base + opc + j) & (kRing - 1)] = comp[src + j];
  }
  void copy(int64_t opc, int64_t dist, int64_t len) {
    for (int64_t j = 0; j < len; ++j)
      ring[(base + opc + j) & (kRing - 1)] = ring[(base + opc - dist + (dist >= len ? j : j % dist)) & (kRing - 1)];
  }
};
}  // namespace

extern "C" void decode_stream_host(const uint8_t* rows, const int32_t* comp_lens, const int32_t* out_lens,
                                   const int32_t* ctx_lens, const uint8_t* ctx0, int64_t n, uint8_t* out,
                                   uint8_t* ok) {
  static uint8_t ring[kRing];
  memcpy(ring, ctx0, snappy_block::kBlockSize);
  int64_t base = snappy_block::kBlockSize;
  for (int64_t c = 0; c < n; ++c) {
    for (int64_t j = 0; j < snappy_block::kBlockSize; ++j) ring[(base + j) & (kRing - 1)] = 0;
    const uint8_t* row = rows + c * snappy_block::kPadOut;
    const int64_t ctx = ctx_lens[c] < 0 ? 0 : (ctx_lens[c] > snappy_block::kBlockSize ? snappy_block::kBlockSize : ctx_lens[c]);
    RingMover mv{row, ring, base};
    ok[c] = snappy_block::decode_block(row, comp_lens[c], out_lens[c], ctx, mv) ? 1 : 0;
    for (int64_t j = 0; j < snappy_block::kBlockSize; ++j)
      out[c * snappy_block::kBlockSize + j] = ring[(base + j) & (kRing - 1)];
    if (out_lens[c] > 0 && out_lens[c] <= snappy_block::kBlockSize) base += out_lens[c];
  }
}

namespace {
struct HostFetch {
  const int32_t* tape;
  snappy_tape::Record operator()(int64_t r) { return snappy_tape::decode_record(tape[2 * r], tape[2 * r + 1]); }
};
struct HostWarp {  // the 32 lanes in reverse, so that an order-dependent move would show
  uint8_t* img;
  void operator()(const snappy_tape::Record& r) {
    for (int lane = snappy_tape::kLanes - 1; lane >= 0; --lane) snappy_tape::lane_move(img, r, lane);
  }
};
}  // namespace

extern "C" int run_tape_host(const int32_t* tape, int64_t nrecs, int64_t cap, const uint8_t* row, uint8_t* out) {
  static uint8_t img[snappy_tape::kImageBytes];
  memset(img, 0, sizeof img);
  memcpy(img + snappy_tape::kCompOff, row, snappy_block::kPadOut);
  HostFetch fetch{tape};
  HostWarp move{img};
  const bool good = snappy_tape::run_tape(nrecs, cap, fetch, move);
  memcpy(out, img + snappy_tape::kOutBase, snappy_block::kBlockSize);
  return good ? 1 : 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("decode_host")
    src, so = d / "harness.cc", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    lib.decode_block_host.argtypes = [P, I64, I64, P]
    lib.decode_block_host.restype = ctypes.c_int
    lib.decode_stream_host.argtypes = [P, P, P, P, P, I64, P, P]
    lib.decode_stream_host.restype = None
    lib.run_tape_host.argtypes = [P, I64, I64, P, P]
    lib.run_tape_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def harness(lib):
    def run(rows, cl, ol):
        rows = np.ascontiguousarray(rows)
        out = np.empty((rows.shape[0], C.MAX_BLOCK_SIZE), np.uint8)
        ok = np.array([lib.decode_block_host(rows[i].ctypes.data, int(cl[i]), int(ol[i]), out[i].ctypes.data)
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


@functools.cache
def _stream_cases():
    """(rows, comp_lens, out_lens, ctx_lens, ctx0) windowed calls: straddling
    and phase-shifted streams, mutated copies of them, a random ctx0 with
    every chunk given the full context, copies at the context's edge, and
    out-of-range lengths."""
    rng = np.random.default_rng(900)
    streams = []
    for seed in (0, 1):
        stream, _ = _build_straddling_stream(seed)
        arr = np.frombuffer(stream, np.uint8)
        n, start = framing.read_preamble(arr)
        streams.append((arr[start:], n))
    for seed in range(3):
        ops, n, _ = _unaligned_stream(np.random.default_rng(4000 + seed), seed)
        streams.append((ops, n))
    cases = []
    for k, (ops, n) in enumerate(streams):
        chunks, out_lens, ctx_lens = framing.split_ops_windowed(ops, n)
        rows, comp_lens = framing.pad_chunks(chunks)
        out_lens = np.asarray(out_lens, np.int32)
        cases.append((rows, comp_lens, out_lens, ctx_lens, np.zeros(C.MAX_BLOCK_SIZE, np.uint8)))
        for _ in range(4):
            bad = rows.copy()
            for _m in range(int(rng.integers(1, 6))):
                i = int(rng.integers(0, bad.shape[0]))
                bad[i, int(rng.integers(0, max(int(comp_lens[i]), 1)))] ^= int(rng.integers(1, 256))
            cases.append((bad, comp_lens, out_lens, ctx_lens, np.zeros(C.MAX_BLOCK_SIZE, np.uint8)))
        ctx0 = rng.integers(0, 256, C.MAX_BLOCK_SIZE, dtype=np.uint8)
        full = np.full(len(chunks), C.MAX_BLOCK_SIZE + (k % 2) * 99, np.int32)  # clamped to 65536
        cases.append((rows, comp_lens, out_lens, full, ctx0))
    # copies at the context's edge: dist = 3 + d is ok with ctx_len d, bad with d - 1
    edge = [d for d in (1, 2, 100, 65533, 65536) for _ in range(2)]
    ops = [np.frombuffer(_lit(b"xyz") + _copy4(5, 3 + d), np.uint8) for d in edge]
    rows, comp_lens = framing.pad_chunks(ops)
    cases.append((rows, comp_lens, np.full(len(edge), 8, np.int32),
                  np.array([d - k % 2 for k, d in enumerate(edge)], np.int32), rng.integers(0, 256, C.MAX_BLOCK_SIZE, dtype=np.uint8)))
    rows, comp_lens, out_lens, ctx_lens, ctx0 = cases[0]
    odd = out_lens.copy()
    odd[0] = C.MAX_BLOCK_SIZE + 1  # out of range: not ok, and the window does not slide
    cases.append((rows, comp_lens, odd, np.maximum(ctx_lens - 5, -3), ctx0))
    return cases


@pytest.mark.parametrize("case", range(32))
def test_ring_decoder_equals_plain_windowed(lib, case):
    """decode_block.cuh with ctx_len > 0 over decode_stream.cu's ring: flags
    and rows equal to the plain windowed decoder for every chunk, before and
    after a malformed one."""
    cases = _stream_cases()
    assert len(cases) == 32
    rows, cl, ol, xl, ctx0 = cases[case]
    rows = np.ascontiguousarray(rows)
    cl, ol, xl = (np.ascontiguousarray(a, np.int32) for a in (cl, ol, xl))
    out = np.empty((rows.shape[0], C.MAX_BLOCK_SIZE), np.uint8)
    ok = np.empty(rows.shape[0], np.uint8)
    lib.decode_stream_host(rows.ctypes.data, cl.ctypes.data, ol.ctypes.data, xl.ctypes.data, ctx0.ctypes.data,
                           rows.shape[0], out.ctypes.data, ok.ctypes.data)
    pout, pok = decode_vm2.decode_stream_ref(*(torch.from_numpy(a) for a in (rows, cl, ol, xl, ctx0)))
    np.testing.assert_array_equal(ok.astype(bool), pok.numpy())
    np.testing.assert_array_equal(out, pout.numpy())
    if case == 30:
        assert ok.tolist() == [1, 0] * 5


def _run_tapes(lib, tapes, nrecs, rows):
    tapes, rows = np.ascontiguousarray(tapes, np.int32), np.ascontiguousarray(rows)
    out = np.empty((rows.shape[0], C.MAX_BLOCK_SIZE), np.uint8)
    ok = np.array([lib.run_tape_host(tapes[b].ctypes.data, int(nrecs[b]), tapes.shape[1] // 2,
                                     rows[b].ctypes.data, out[b].ctypes.data) for b in range(rows.shape[0])], bool)
    return out, ok


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tape_walk_equals_plain_run_tape(lib, family):
    """decode_tape.cuh's walk with the kernel's lane indexing, on builder
    tapes of test_torch_decode.py's rows: equal to the plain _run_tape and,
    where ok, to the JAX decoder's rows."""
    if not cpu.available:
        pytest.skip("the tape builder needs the native runtime")
    rows, cl, ol, jout, jok = decoded(family)
    tapes, nrecs = decode_tape.build_tapes(rows, cl, ol)
    out, ok = _run_tapes(lib, tapes, nrecs, rows)
    pout, pok = decode_tape.run_tape_ref(torch.from_numpy(tapes), torch.from_numpy(nrecs), torch.from_numpy(rows))
    np.testing.assert_array_equal(ok, pok.numpy())
    np.testing.assert_array_equal(ok, nrecs >= 0)
    np.testing.assert_array_equal(out, pout.numpy())
    np.testing.assert_array_equal(out[ok], jout[ok])


@pytest.mark.parametrize("seed", range(3))
def test_tape_walk_equals_plain_on_random_records(lib, seed):
    """Random records, overlapping copies and records that leave the image
    among them: the header's walk and the plain version agree on every flag
    and byte (both stop at the first record they refuse)."""
    rng = np.random.default_rng(600 + seed)
    B, S = 48, 64
    img = decode_tape.IMAGE_BYTES
    src = rng.integers(0, 1 << 18, (B, S))
    src = np.where(rng.random((B, S)) < 0.9, src % img, src)
    dst = np.where(rng.random((B, S)) < 0.95, rng.integers(0, img, (B, S)), rng.integers(-600, img + 600, (B, S)))
    ln = np.where(rng.random((B, S)) < 0.95, rng.integers(0, decode_tape.PIECE_MAX + 1, (B, S)),
                  rng.integers(0, 4096, (B, S)))
    pk2 = rng.integers(0, 4, (B, S))
    tapes = np.stack([(src | pk2 << 18 | ln << 20).astype(np.uint32).view(np.int32), dst.astype(np.int32)], -1)
    tapes = tapes.reshape(B, 2 * S)
    nrecs = rng.integers(-10, S + 3, B).astype(np.int32)
    rows = rng.integers(0, 256, (B, C.MAX_COMPRESSED_BLOCK_SIZE), dtype=np.uint8)
    out, ok = _run_tapes(lib, tapes, nrecs, rows)
    pout, pok = decode_tape.run_tape_ref(torch.from_numpy(tapes), torch.from_numpy(nrecs), torch.from_numpy(rows))
    np.testing.assert_array_equal(ok, pok.numpy())
    np.testing.assert_array_equal(out, pout.numpy())
    assert 0 < ok.sum() < B
