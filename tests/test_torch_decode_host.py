"""The kernels' shared headers, checked from their own source without a GPU.

snappytpu_torch/csrc/decode_block.cuh holds the op rules, the op parser and
the op-by-op decode loop (K3); decode_pipe.cuh holds K2's parse -> move
pipeline, whose pieces K4 and K5 reuse; decode_tape.cuh holds the tape
record format, K5's producer and K6's record-by-record walk.  All are
host+device code.  Here g++ builds them into a tiny host harness:
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
  * K4: both launches, K2's sizer and its judge with each chunk's ctx_len
    writing records (K4a), then the records moved a batch at a time over
    the kernel's linear image of context and output, slid by out_len after
    each chunk (K4b), held against the plain windowed decoder on 32 calls
    (malformed chunks, a random ctx0, copies at the context's edge,
    lengths out of range);
  * K5: the producer (records checked and converted, batches that are not
    forward cut record by record) straight into K2's mover, held against
    the plain _run_tape on builder tapes, random records and forward
    records anywhere in the image;
  * K6: the record-by-record walk with the kernel's lane indexing (32 lanes
    emulated in reverse order; fills index j % p), held against the plain
    _run_tape.
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
#include <vector>
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
  return snappy_block::decode_block(row, comp_len, out_len, mv) ? 1 : 0;
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
    good = snappy_pipe::judge_block(w, comp_len, out_len, 0, windows, sink);
  }
  memcpy(out, img, snappy_block::kBlockSize);
  return good ? 1 : 0;
}

namespace {
struct RecordSink {  // decode_stream.cu's: K4a's records, in order, to the chunk's part of the buffer
  Rec* recs;
  int count = 0;
  Rec* room(int) { return recs + count; }
  void commit(int n) { count += n; }
  void finish() {}
};

// A row staged as the kernels stage it: comp_len bytes rounded up to 16,
// kSlack zero bytes, garbage after (none for lengths out of range).
void stage_row(uint8_t* comp_s, const uint8_t* row, int32_t comp_len) {
  memset(comp_s, 0xA5, snappy_block::kPadOut + snappy_pipe::kSlack);
  const int nrow = 0 <= comp_len && comp_len <= snappy_block::kPadOut ? (comp_len + 15) / 16 : 0;
  memcpy(comp_s, row, 16 * nrow);
  memset(comp_s + 16 * nrow, 0, snappy_pipe::kSlack);
}
}  // namespace

// K4 on the host, both launches: K4a parses every chunk (K2's sizer, its
// judge with the chunk's ctx_len) into records; K4b moves them chunk by
// chunk over decode_stream.cu's linear image (64 KiB of context, then the
// chunk's output) and slides it by out_len.  stats = {records, groups}.
extern "C" void decode_stream_host(const uint8_t* rows, const int32_t* comp_lens, const int32_t* out_lens,
                                   const int32_t* ctx_lens, const uint8_t* ctx0, int64_t n, uint8_t* out,
                                   uint8_t* ok, int64_t* stats) {
  constexpr int64_t kBS = snappy_block::kBlockSize;
  constexpr int64_t kCap = snappy_block::kPadOut / 2;
  static uint8_t comp_s[snappy_block::kPadOut + snappy_pipe::kSlack];
  std::vector<Rec> recs(n * kCap);
  std::vector<int32_t> nrecs(n, 0);
  PipeWarp w{&stats[1]};
  for (int64_t c = 0; c < n; ++c) {  // K4a: the chunks are independent
    const int32_t cl = comp_lens[c], ol = out_lens[c];
    ok[c] = 0;
    if (cl < 0 || cl > snappy_block::kPadOut || ol < 0 || ol > kBS) continue;
    stage_row(comp_s, rows + c * snappy_block::kPadOut, cl);
    PipeWindows windows;
    snappy_pipe::size_block(w, comp_s, cl, windows);
    RecordSink sink{recs.data() + c * kCap};
    const int32_t ctx = ctx_lens[c] < 0 ? 0 : (ctx_lens[c] > kBS ? kBS : ctx_lens[c]);
    ok[c] = snappy_pipe::judge_block(w, cl, ol, ctx, windows, sink) ? 1 : 0;
    nrecs[c] = sink.count;
    stats[0] += sink.count;
  }
  static uint8_t img[2 * kBS];
  memcpy(img, ctx0, kBS);
  for (int64_t c = 0; c < n; ++c) {  // K4b: in order
    stage_row(comp_s, rows + c * snappy_block::kPadOut, comp_lens[c]);
    memset(img + kBS, 0, kBS);
    snappy_pipe::move_records(w, recs.data() + c * kCap, nrecs[c], comp_s, img + kBS);
    memcpy(out + c * kBS, img + kBS, kBS);
    if (out_lens[c] > 0 && out_lens[c] <= kBS) memmove(img, img + out_lens[c], kBS);
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

namespace {
struct TapeLoad {  // decode_tape.cu's: lane l gets record r + l's words, zeros past nrecs
  const int32_t* tape;
  int32_t nrecs;
  void operator()(PipeWarp&, int32_t r, PipeWarp::Var<int32_t>& w0, PipeWarp::Var<int32_t>& w1) const {
    for (int l = 0; l < 32; ++l) {
      w0[l] = r + l < nrecs ? tape[2 * (r + l)] : 0;
      w1[l] = r + l < nrecs ? tape[2 * (r + l) + 1] : 0;
    }
  }
};
}  // namespace

// K5's kernel body on the host: the producer's batches straight to
// move_batch with comp = out = img.  stats = {batches, groups}.
extern "C" int run_tape_pipe_host(const int32_t* tape, int64_t nrecs, int64_t cap, const uint8_t* row, uint8_t* out,
                                  int64_t* stats) {
  static uint8_t img[snappy_tape::kImageBytes + 16];  // a word move may read a word past its source
  memset(img, 0, sizeof img);
  memcpy(img + snappy_tape::kCompOff, row, snappy_block::kPadOut);
  bool good = false;
  if (0 <= nrecs && nrecs <= cap) {
    PipeWarp w{&stats[1]};
    PipeSink sink{w, img, img, &stats[0]};
    TapeLoad load{tape, static_cast<int32_t>(nrecs)};
    good = snappy_tape::produce_tape(w, static_cast<int32_t>(nrecs), load, sink);
  }
  memcpy(out, img + snappy_tape::kOutBase, snappy_block::kBlockSize);
  return good ? 1 : 0;
}

// K6's walk (decode_tape.cuh's run_tape) on the host.
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
    lib.decode_stream_host.argtypes = [P, P, P, P, P, I64, P, P, P]
    lib.decode_stream_host.restype = None
    lib.run_tape_host.argtypes = [P, I64, I64, P, P]
    lib.run_tape_host.restype = ctypes.c_int
    lib.run_tape_pipe_host.argtypes = [P, I64, I64, P, P, P]
    lib.run_tape_pipe_host.restype = ctypes.c_int
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
    """K4's two launches on the host, K2's judge with ctx_len > 0 to a record
    buffer, then the records moved over decode_stream.cu's linear image with
    its slide: flags and rows equal to the plain windowed decoder for every
    chunk, before and after a malformed one."""
    cases = _stream_cases()
    assert len(cases) == 32
    rows, cl, ol, xl, ctx0 = cases[case]
    rows = np.ascontiguousarray(rows)
    cl, ol, xl = (np.ascontiguousarray(a, np.int32) for a in (cl, ol, xl))
    out = np.empty((rows.shape[0], C.MAX_BLOCK_SIZE), np.uint8)
    ok = np.empty(rows.shape[0], np.uint8)
    stats = np.zeros(2, np.int64)
    lib.decode_stream_host(rows.ctypes.data, cl.ctypes.data, ol.ctypes.data, xl.ctypes.data, ctx0.ctypes.data,
                           rows.shape[0], out.ctypes.data, ok.ctypes.data, stats.ctypes.data)
    pout, pok = decode_vm2.decode_stream_ref(*(torch.from_numpy(a) for a in (rows, cl, ol, xl, ctx0)))
    np.testing.assert_array_equal(ok.astype(bool), pok.numpy())
    np.testing.assert_array_equal(out, pout.numpy())
    assert 0 < stats[1] < stats[0]  # records joined and grouped, fewer groups than records
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
    B = 48
    tapes, nrecs = _random_tapes(rng, B, 64)
    rows = rng.integers(0, 256, (B, C.MAX_COMPRESSED_BLOCK_SIZE), dtype=np.uint8)
    out, ok = _run_tapes(lib, tapes, nrecs, rows)
    pout, pok = decode_tape.run_tape_ref(torch.from_numpy(tapes), torch.from_numpy(nrecs), torch.from_numpy(rows))
    np.testing.assert_array_equal(ok, pok.numpy())
    np.testing.assert_array_equal(out, pout.numpy())
    assert 0 < ok.sum() < B


def _run_tape_pipe(lib, tapes, nrecs, rows):
    """K5's producer and mover on the host -> (rows, ok, {batches, groups})."""
    tapes, rows = np.ascontiguousarray(tapes, np.int32), np.ascontiguousarray(rows)
    out = np.empty((rows.shape[0], C.MAX_BLOCK_SIZE), np.uint8)
    stats = np.zeros(2, np.int64)
    ok = np.array([lib.run_tape_pipe_host(tapes[b].ctypes.data, int(nrecs[b]), tapes.shape[1] // 2,
                                          rows[b].ctypes.data, out[b].ctypes.data, stats.ctypes.data)
                   for b in range(rows.shape[0])], bool)
    return out, ok, {"batches": int(stats[0]), "groups": int(stats[1])}


def _one_batch_per_step(nrecs, cap):
    """The batches a tape of forward steps makes: one per 32 records, and
    one empty batch for an empty tape."""
    nr = np.asarray(nrecs, np.int64)
    nr = nr[(nr >= 0) & (nr <= cap)]
    return int(np.maximum((nr + 31) // 32, 1).sum())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tape_pipe_equals_plain_run_tape(lib, family):
    """K5's producer (checks, conversion to image-coordinate records) and
    K2's grouped mover, on builder tapes of test_torch_decode.py's rows:
    equal to the plain _run_tape and, where ok, to the JAX decoder's rows.
    Every batch of a builder tape is forward: one batch per 32 records."""
    if not cpu.available:
        pytest.skip("the tape builder needs the native runtime")
    rows, cl, ol, jout, jok = decoded(family)
    tapes, nrecs = decode_tape.build_tapes(rows, cl, ol)
    out, ok, stats = _run_tape_pipe(lib, tapes, nrecs, rows)
    pout, pok = decode_tape.run_tape_ref(torch.from_numpy(tapes), torch.from_numpy(nrecs), torch.from_numpy(rows))
    np.testing.assert_array_equal(ok, pok.numpy())
    np.testing.assert_array_equal(ok, nrecs >= 0)
    np.testing.assert_array_equal(out, pout.numpy())
    np.testing.assert_array_equal(out[ok], jout[ok])
    assert stats["batches"] == _one_batch_per_step(nrecs, tapes.shape[1] // 2)


def _random_tapes(rng, B: int, S: int):
    """test_tape_walk_equals_plain_on_random_records's records: random, with
    overlapping copies and records that leave the image among them."""
    img = decode_tape.IMAGE_BYTES
    src = rng.integers(0, 1 << 18, (B, S))
    src = np.where(rng.random((B, S)) < 0.9, src % img, src)
    dst = np.where(rng.random((B, S)) < 0.95, rng.integers(0, img, (B, S)), rng.integers(-600, img + 600, (B, S)))
    ln = np.where(rng.random((B, S)) < 0.95, rng.integers(0, decode_tape.PIECE_MAX + 1, (B, S)),
                  rng.integers(0, 4096, (B, S)))
    pk2 = rng.integers(0, 4, (B, S))
    tapes = np.stack([(src | pk2 << 18 | ln << 20).astype(np.uint32).view(np.int32), dst.astype(np.int32)], -1)
    return tapes.reshape(B, 2 * S), rng.integers(-10, S + 3, B).astype(np.int32)


@pytest.mark.parametrize("seed", range(3))
def test_tape_pipe_equals_plain_on_random_records(lib, seed):
    """K5's producer on the random records of the walk's fuzz, whose batches
    are not forward (dsts not contiguous, sources after their dsts): one
    record per batch, every flag and byte equal to the plain version."""
    rng = np.random.default_rng(600 + seed)
    tapes, nrecs = _random_tapes(rng, 48, 64)
    rows = rng.integers(0, 256, (48, C.MAX_COMPRESSED_BLOCK_SIZE), dtype=np.uint8)
    out, ok, stats = _run_tape_pipe(lib, tapes, nrecs, rows)
    pout, pok = decode_tape.run_tape_ref(torch.from_numpy(tapes), torch.from_numpy(nrecs), torch.from_numpy(rows))
    np.testing.assert_array_equal(ok, pok.numpy())
    np.testing.assert_array_equal(out, pout.numpy())
    assert 0 < ok.sum() < 48
    assert stats["batches"] > _one_batch_per_step(nrecs, 64)


def _forward_tapes(rng, B: int, S: int):
    """Tapes whose records are contiguous and read before their dst, as the
    builder's are, but anywhere in the image (the guard and the compressed
    row too): copies from far back, from the batch's own output and from the
    compressed row, fills of period 1, 2 and 4, runs at one distance that
    join, empty records; in some tapes one record whose source lies after
    its dst (a batch that is not forward) or one that is refused."""
    img = decode_tape.IMAGE_BYTES
    tapes = np.zeros((B, S, 2), np.int64)
    nrecs = np.zeros(B, np.int32)
    for b in range(B):
        dst = int(rng.integers(600, img // 2))
        dist = 0
        for r in range(S):
            ln = int((rng.integers(0, 17), rng.integers(17, 128), rng.integers(128, decode_tape.PIECE_MAX + 1))[r % 3])
            if dst + ln > img:
                break
            kind = rng.random()
            if kind < 0.2:
                pk2, src = int(rng.integers(1, 4)), 0
            else:
                pk2 = 0
                if kind < 0.45 or dist < ln or dist > dst:  # a new distance: from far back or from the batch's output
                    dist = int(rng.integers(ln, dst + 1)) if rng.random() < 0.5 else int(rng.integers(ln, 3 * ln + 2))
                    dist = max(min(dist, dst), 1)
                src = dst - dist
                if ln > dist:
                    ln = dist
            tapes[b, r] = (src | pk2 << 18 | ln << 20, dst)
            nrecs[b] = r + 1
            dst += ln
        k = int(rng.integers(0, max(nrecs[b], 1)))
        if b % 6 == 1:  # a source after its dst, not overlapping
            tapes[b, k, 0] = (tapes[b, k, 1] + 600) | 100 << 20
        elif b % 6 == 3:  # an overlapping copy: refused
            tapes[b, k, 0] = (tapes[b, k, 1] - 10) | 100 << 20
    w0 = tapes[..., 0].astype(np.uint32).view(np.int32)
    return np.stack([w0, tapes[..., 1].astype(np.int32)], -1).reshape(B, 2 * S), nrecs


@pytest.mark.parametrize("seed", range(3))
def test_tape_pipe_equals_plain_on_forward_records(lib, seed):
    """K5's producer and grouped mover on forward batches that the builder
    does not make: records that read what the batch just wrote (group cuts),
    runs at one distance (joined), records in the guard and the compressed
    row; with a non-forward batch and a refused record in some tapes."""
    rng = np.random.default_rng(800 + seed)
    B, S = 36, 96
    tapes, nrecs = _forward_tapes(rng, B, S)
    rows = rng.integers(0, 256, (B, C.MAX_COMPRESSED_BLOCK_SIZE), dtype=np.uint8)
    out, ok, stats = _run_tape_pipe(lib, tapes, nrecs, rows)
    pout, pok = decode_tape.run_tape_ref(torch.from_numpy(tapes), torch.from_numpy(nrecs), torch.from_numpy(rows))
    np.testing.assert_array_equal(ok, pok.numpy())
    np.testing.assert_array_equal(out, pout.numpy())
    assert ok[0::6].all() and not ok[3::6].any()
    steps = _one_batch_per_step(nrecs, S)
    assert steps < stats["batches"] < int(nrecs.sum())  # non-forward batches record by record, the rest whole
    assert stats["groups"] < int(nrecs.sum())
