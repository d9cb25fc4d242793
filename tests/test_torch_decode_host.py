"""The kernels' shared headers, checked from their own source without a GPU.

snappytpu_torch/csrc/decode_block.cuh holds the op rules, the op parser and
the op-by-op decode loop (K3, K4); decode_pipe.cuh holds K2's parse -> move
pipeline; decode_tape.cuh holds the tape record format and how a warp's
lanes move a record (K5, K6).  All are host+device code.  Here g++ builds
them into a tiny host harness:
  * K3: a mover with the kernel's parallel copy indexing
    (out[opc + j] = out[opc - dist + j % dist]), held against the plain
    version and the JAX decoder on the rows of test_torch_decode.py, plus a
    seeded mutation fuzz against the plain version;
  * K2: decode_pipe.cuh's sizer, judge and mover under a host warp policy
    that runs the 32 lanes one after another (in reverse, so that an
    order-dependent move would show), the sizer to the row's end first, staged as the kernel stages a row
    (comp_len bytes rounded up to 16, then 64 zero bytes, garbage after;
    the image zeroed from out_len on, garbage before), held against the
    plain version on the same rows, the mutation fuzz, hand cases and rows
    with garbage past comp_len;
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

from snappytpu.format import constants as C
from snappytpu.stream import framing
from snappytpu_torch import _build, cpu
from snappytpu_torch.kernels import decode_tape, decode_vm2, decode_vm4
from test_fuzz_decode import _unaligned_stream
from test_stream_decode import _build_straddling_stream, _copy2, _copy4, _lit
from test_torch_decode import FAMILIES, _rows, decoded, golden_streams, own_streams

HARNESS = r"""
#include <string.h>
#include <deque>
#include "decode_block.cuh"
#include "decode_pipe.cuh"
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
using snappy_pipe::Rec;

struct PipeWarp {  // decode_pipe.cuh's warp policy, the 32 lanes one by one
  template <class T>
  struct Var {
    T v[32];
    T& operator[](int l) { return v[l]; }
    const T& operator[](int l) const { return v[l]; }
  };
  int64_t* groups;
  template <class F>
  void each(F f) {
    for (int l = 31; l >= 0; --l) f(l);
  }
  int32_t shfl(const Var<int32_t>& x, int src) const { return x[src]; }
  Var<int32_t> gather(const Var<int32_t>& x, const Var<int32_t>& i) const {
    Var<int32_t> y;
    for (int l = 0; l < 32; ++l) y[l] = x[i[l]];
    return y;
  }
  int32_t reduce_or(const Var<int32_t>& x) const {
    int32_t m = 0;
    for (int l = 0; l < 32; ++l) m |= x[l];
    return m;
  }
  uint32_t ballot(const Var<bool>& p) const {
    uint32_t m = 0;
    for (int l = 0; l < 32; ++l) m |= static_cast<uint32_t>(p[l]) << l;
    return m;
  }
  void excl_scan(Var<int32_t>& x) const {
    int32_t s = 0;
    for (int l = 0; l < 32; ++l) {
      const int32_t v = x[l];
      x[l] = s;
      s += v;
    }
  }
  void sync() const { ++*groups; }
};

struct PipeWindows {  // the sizer's windows, in order, for the judge
  struct Win {
    int32_t ip;
    uint32_t starts;
    snappy_pipe::Head head[32];
    int32_t len[32];
  };
  std::deque<Win> q;
  bool stopped(PipeWarp&) const { return false; }
  void push(PipeWarp&, int32_t ip, const snappy_pipe::Window<PipeWarp>& win, bool) {
    Win x{ip, win.starts, {}, {}};
    for (int l = 0; l < 32; ++l) {
      x.head[l] = win.head[l];
      x.len[l] = win.op[l].len;
    }
    q.push_back(x);
  }
  void take(PipeWarp&, int32_t& ip, uint32_t& starts, PipeWarp::Var<snappy_pipe::Head>& head,
            PipeWarp::Var<int32_t>& len) {
    const Win& x = q.front();
    ip = x.ip;
    starts = x.starts;
    for (int l = 0; l < 32; ++l) {
      head[l] = x.head[l];
      len[l] = x.len[l];
    }
  }
  void release(PipeWarp&) { q.pop_front(); }
  void finish(PipeWarp&) {}
};

struct PipeSink {  // hands each batch straight to the mover
  PipeWarp& w;
  const uint8_t* comp;
  uint8_t* out;
  int64_t* batches;
  Rec recs[snappy_pipe::kBatch];
  int count = 0;
  Rec* room(int n) {
    if (count + n > snappy_pipe::kBatch) flush();
    return recs + count;
  }
  void commit(int n) { count += n; }
  void finish() { flush(); }
  void flush() {
    PipeWarp::Var<Rec> rec;
    for (int l = 0; l < 32; ++l) rec[l] = l < count ? recs[l] : Rec{0, 0, 0, 0};
    snappy_pipe::move_batch(w, rec, count, comp, out);
    ++*batches;
    count = 0;
  }
};
}  // namespace

// K2's kernel body on the host: stats = {batches, groups}.
extern "C" int decode_pipe_host(const uint8_t* row, int32_t comp_len, int32_t out_len, uint8_t* out, int64_t* stats) {
  static uint8_t comp_s[snappy_block::kPadOut + snappy_pipe::kSlack];
  static uint8_t img[snappy_block::kBlockSize];
  memset(comp_s, 0xA5, sizeof comp_s);
  memset(img, 0x5A, sizeof img);
  const bool valid = 0 <= comp_len && comp_len <= snappy_block::kPadOut && 0 <= out_len &&
                     out_len <= snappy_block::kBlockSize;
  const int nrow = valid ? (comp_len + 15) / 16 : 0;
  memcpy(comp_s, row, 16 * nrow);
  memset(comp_s + 16 * nrow, 0, snappy_pipe::kSlack);
  const int zero_from = valid ? 16 * (out_len / 16) : 0;
  memset(img + zero_from, 0, snappy_block::kBlockSize - zero_from);
  bool good = false;
  if (valid) {
    PipeWarp w{&stats[1]};
    PipeWindows windows;
    snappy_pipe::size_block(w, comp_s, comp_len, windows);  // the sizer runs ahead, here to the end
    PipeSink sink{w, comp_s, img, &stats[0]};
    good = snappy_pipe::judge_block(w, comp_len, out_len, windows, sink);
  }
  memcpy(out, img, snappy_block::kBlockSize);
  return good ? 1 : 0;
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
    lib.decode_pipe_host.argtypes = [P, ctypes.c_int32, ctypes.c_int32, P, P]
    lib.decode_pipe_host.restype = ctypes.c_int
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


@pytest.fixture(scope="module")
def pipe(lib):
    """K2's walk on the host -> (rows, ok, {batches, groups})."""

    def run(rows, cl, ol):
        rows = np.ascontiguousarray(rows)
        out = np.empty((rows.shape[0], C.MAX_BLOCK_SIZE), np.uint8)
        stats = np.zeros(2, np.int64)
        ok = np.array([lib.decode_pipe_host(rows[i].ctypes.data, int(cl[i]), int(ol[i]), out[i].ctypes.data,
                                            stats.ctypes.data) for i in range(rows.shape[0])], bool)
        return out, ok, {"batches": int(stats[0]), "groups": int(stats[1])}

    return run


def _pipe_agrees(pipe, rows, cl, ol):
    """Flags equal to the plain version everywhere, rows where ok."""
    out, ok, stats = pipe(rows, cl, ol)
    pout, pok = decode_vm4.decode_blocks_ref(torch.from_numpy(rows), torch.from_numpy(cl), torch.from_numpy(ol))
    np.testing.assert_array_equal(ok, pok.numpy(), err_msg="ok vs plain")
    np.testing.assert_array_equal(out[ok], pout.numpy()[ok], err_msg="rows vs plain")
    return ok, stats


def _garbage_tail(rows, cl, rng):
    """The rows with random bytes past comp_len (where comp_len is in range)."""
    rows = rows.copy()
    for i in range(rows.shape[0]):
        if 0 <= cl[i] < C.MAX_COMPRESSED_BLOCK_SIZE:
            rows[i, cl[i]:] = rng.integers(0, 256, C.MAX_COMPRESSED_BLOCK_SIZE - cl[i], dtype=np.uint8)
    return rows


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pipe_equals_jax_and_plain(pipe, family):
    rows, cl, ol, jout, jok = decoded(family)
    ok, _ = _pipe_agrees(pipe, rows, cl, ol)
    np.testing.assert_array_equal(ok, jok, err_msg="ok vs JAX")
    out, _, _ = pipe(rows, cl, ol)
    np.testing.assert_array_equal(out[ok], jout[ok], err_msg="rows vs JAX")


@pytest.mark.parametrize("seed", range(4))
def test_pipe_equals_plain_on_mutation_fuzz(pipe, seed):
    """test_host_build_equals_plain_on_mutation_fuzz's mutations, half of
    the rows with garbage past comp_len."""
    rng = np.random.default_rng(700 + seed)
    base = own_streams() + golden_streams()
    streams = []
    for _ in range(300):
        ops, n = base[int(rng.integers(0, len(base)))]
        arr = bytearray(ops)
        for _ in range(int(rng.integers(1, 4))):
            arr[int(rng.integers(0, len(arr)))] = int(rng.integers(0, 256))
        cut = len(arr) if rng.random() < 0.8 else int(rng.integers(0, len(arr) + 1))
        streams.append((bytes(arr[:cut]), n if rng.random() < 0.9 else int(rng.integers(0, C.MAX_BLOCK_SIZE + 1))))
    rows, cl, ol = _rows(streams)
    rows[::2] = _garbage_tail(rows[::2], cl[::2], rng)
    ok, _ = _pipe_agrees(pipe, rows, cl, ol)
    assert 0 < ok.sum() < ok.size


def _copy1(length: int, dist: int) -> bytes:
    assert 4 <= length <= 11 and 1 <= dist < 2048
    return bytes([((dist >> 8) << 5) | ((length - 4) << 2) | C.TAG_COPY1, dist & 0xFF])


def _copy(length: int, dist: int) -> bytes:
    return _copy1(length, dist) if 4 <= length <= 11 and dist < 2048 else _copy2(length, dist)


def _fill(periods, n: int):
    """A literal of max(periods) bytes, then n copies of lengths 4..64 at
    the distances `periods` in turn: a fill whose records each read the one
    before (at one distance the mover joins them into one record)."""
    ops, out = bytearray(_lit(bytes(range(65, 65 + max(periods))))), max(periods)
    for k in range(n):
        ln = (4, 11, 64, 7, 33, 5, 60, 9)[k % 8]
        ops += _copy(ln, periods[k % len(periods)])
        out += ln
    return bytes(ops), out


def _inside_batch():
    """Copies whose sources lie in their own batch: the records right after
    a literal read it, a self-overlapping copy of period 5, and a copy that
    spans a literal and two copies."""
    ops = _lit(b"abcdefghij") + _copy(10, 10) + _copy(20, 5) + _lit(b"XYZ") + _copy(8, 23) + _copy(6, 1)
    out = 10 + 10 + 20 + 3 + 8 + 6
    return [(ops, out), (ops + _lit(b"q" * 40) + _copy(30, 50) + _copy(64, 41), out + 40 + 30 + 64)]


def _far_copies():
    """A 3000-byte literal, then 200 copies reaching back 2500-3000 bytes:
    past their own batch, but for the first batch's, which read the
    literal."""
    rng = np.random.default_rng(5)
    ops, out = bytearray(_lit(rng.integers(0, 256, 3000, dtype=np.uint8).tobytes())), 3000
    for _ in range(200):
        ln = int(rng.integers(4, 65))
        ops += _copy(ln, int(rng.integers(2500, 3000)))
        out += ln
    return [(bytes(ops), out)]


def _bad_mid_batch():
    """A bad op as the 11th of 20: a copy reaching before the block, a
    COPY4 with a nonzero 4th offset byte, a literal past comp_len (the
    tail is cut), a zero distance."""
    head = _lit(b"0123456789") + b"".join(_copy(5, 3 + k) for k in range(9))
    tail = b"".join(_copy(4, 2) for _ in range(9))
    n = 10 + 45 + 4 + 36
    bads = [_copy2(4, 60), bytes([(3 << 2) | C.TAG_COPY4, 2, 0, 0, 1]), bytes([C.TAG_COPY1, 0])]
    cases = [(head + b + tail, n) for b in bads]
    cases.append((head + _lit(b"x" * 30) + tail, n - 4 + 30))  # control: valid
    cases.append((head + _lit(b"x" * 30)[:-3], n))  # the literal runs past comp_len
    return cases


def _exact_ends():
    """Streams whose ops end exactly at comp_len and out_len, comp_len around
    multiples of the 32-byte window (a COPY2 among COPY1s makes it odd);
    then out_len one short or long, comp_len one long or short."""
    cases = []
    for size in (31, 32, 33, 63, 64, 65, 95, 96):
        k = (size - 2) // 2
        ops = _lit(b"a") + _copy1(4, 1) * k
        if size % 2:
            ops = ops[:-2] + _copy2(4, 1)
        assert len(ops) == size
        out = 1 + 4 * k
        cases += [(ops, out), (ops, out - 1), (ops, out + 1), (ops + b"\x00", out), (ops[:-1], out)]
    return cases


def _long_literals():
    """4-byte literal lengths: near 2^30 (past the row), with b4's top bits
    set, and a short literal written with four length bytes."""
    tag4 = bytes([63 << 2])
    return [
        (tag4 + bytes([0xFF, 0xFF, 0xFF, 0x3F]) + b"z" * 40, 40),
        (tag4 + bytes([0xFE, 0xFF, 0xFF, 0x3F]) + b"z" * 40, 40),
        (tag4 + bytes([9, 0, 0, 0x40]) + b"0123456789", 10),
        (tag4 + bytes([9, 0, 0, 0x80]) + b"0123456789", 10),
        (tag4 + bytes([9, 0, 0, 0]) + b"0123456789", 10),
        (bytes([62 << 2, 0xFF, 0xFF, 0xFF]) + b"y" * 50, 50),
        (bytes([62 << 2, 49, 0, 0]) + b"y" * 50 + _copy(64, 50), 114),
    ]


def _joined_long_copies():
    """Copies at one distance >= their joined length, joined into records of
    128 bytes or more, which the warp moves a word per lane: destinations
    and sources off word alignment, and a literal of 1000 bytes."""
    rng = np.random.default_rng(9)
    lit = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    cases = []
    for dist in (300, 301, 302, 303):
        ops = _lit(lit[:dist]) + _copy(64, dist) * 4 + _copy(7, dist) + _lit(lit[: 131 + dist % 4]) + _copy(64, dist) * 3
        cases.append((ops, dist + 256 + 7 + 131 + dist % 4 + 192))
    return cases


HAND_CASES = {
    "fill_1": lambda: [_fill((1,), 150)],
    "fill_2": lambda: [_fill((2,), 150)],
    "fill_4": lambda: [_fill((4,), 150)],
    "fill_1_2_4": lambda: [_fill((1, 2, 4), 150)],
    "inside_batch": _inside_batch,
    "joined_long_copies": _joined_long_copies,
    "far_copies": _far_copies,
    "bad_mid_batch": _bad_mid_batch,
    "exact_ends": _exact_ends,
    "long_literals": _long_literals,
}


@pytest.mark.parametrize("name", sorted(HAND_CASES))
@pytest.mark.parametrize("tail", ["zero", "garbage"])
def test_pipe_hand_cases(pipe, name, tail):
    streams = HAND_CASES[name]()
    rows, cl, ol = _rows(streams)
    if tail == "garbage":
        rows = _garbage_tail(rows, cl, np.random.default_rng(len(name)))
    ok, stats = _pipe_agrees(pipe, rows, cl, ol)
    want = {
        "fill_1": [True], "fill_2": [True], "fill_4": [True], "fill_1_2_4": [True], "joined_long_copies": [True] * 4,
        "inside_batch": [True, True], "far_copies": [True],
        "bad_mid_batch": [False, False, False, True, False], "long_literals": [False, False, False, False, True,
                                                                                False, True],
    }
    if name in want:
        assert ok.tolist() == want[name]
    if name in ("fill_1", "fill_2", "fill_4"):  # a batch's copies join into one: the literal's group, then one each
        assert stats["batches"] >= 5 and stats["groups"] == stats["batches"] + 1
    if name == "fill_1_2_4":  # each record reads the one before at another distance: a group each
        assert stats["batches"] >= 5 and stats["groups"] == 151
    if name == "far_copies":  # only the first batch's copies read it (the literal): a group per batch but one
        assert stats["batches"] >= 6 and stats["groups"] == stats["batches"] + 1
    if name == "inside_batch":
        assert stats["groups"] > stats["batches"]
    if name == "exact_ends":
        assert ok[0::5].all() and not ok[1::5].any() and not ok[2::5].any() and not ok[3::5].any()
        assert not ok[4::5].any()


def test_pipe_refuses_lengths_out_of_range(pipe):
    rows, cl, ol = _rows([(_lit(b"abc"), 3)] * 4)
    cl = np.array([-1, C.MAX_COMPRESSED_BLOCK_SIZE + 1, 4, 4], np.int32)
    ol = np.array([3, 3, -1, C.MAX_BLOCK_SIZE + 1], np.int32)
    out, ok, stats = pipe(rows, cl, ol)
    assert not ok.any() and stats["batches"] == 0
    assert not out.any()  # the kernel zeroes the image of such a row


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
