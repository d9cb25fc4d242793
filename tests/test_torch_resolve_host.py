"""K3's and K6's resolver, checked from its own source without a GPU.

snappytpu_torch/csrc/decode_resolve.cuh holds the byte-source resolver:
each output byte takes its record's source, then rounds of pointer jumping
resolve every chain at once.  K6 runs it on the host builder's tapes (with
the record walk for a hand-made tape whose records are not in ascending
order), K3 on the records of K4a's parse.  Here g++ builds the header into a
host harness, together with test_torch_decode_host.py's (K2's sizer and
judge under a host warp policy, and K6's walk), under a block policy that
runs the 1024 threads of each phase one after another, in order and in
reverse, and watches every access to the shared image between two
barriers: an element that one thread reads or writes and another writes in
the same phase is counted as a race, and every case asserts there were
none, so a missing barrier fails here and not only on the card.

  * K6 (resolve_tape_host): the plan (the first refused record, the order
    check), then the resolver or the walk, held byte for byte and flag for
    flag against the plain run_tape_ref on the builder's tapes of every
    family (and where ok the JAX decoder's rows), on random records, on
    hand-made tapes inside the output region (copies from the guard, the row
    and the output, reads past their own end, fills, gaps, empty records,
    refused records) and on out-of-order tapes, which take the walk;
  * K3 (resolve_blocks_host): K2's sizer and judge with ctx_len 0 writing
    records (K4a), then the resolver, held against decode_blocks_ref and the
    JAX decode_blocks_vm2 (Pallas in interpret mode) on every family, the
    mutation fuzz and the hand cases of test_torch_decode_host.py.

No builder tape may take the walk, and no block may need more than 16
rounds; the rounds' distribution per family is printed (pytest -s).
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.kernels.decode_vm2 import decode_blocks_vm2 as jax_vm2
from snappytpu.kernels.encode_v2 import encode_blocks_v2 as jax_encode
from snappytpu_torch import _build, cpu
from snappytpu_torch.kernels import decode_tape, decode_vm4
from test_torch_decode import FAMILIES, _lit, _rows, golden_streams, own_streams
from test_torch_decode_host import HAND_CASES, HARNESS as DECODE_HARNESS, _copy1, _random_tapes

BS, PAD_OUT = C.MAX_BLOCK_SIZE, C.MAX_COMPRESSED_BLOCK_SIZE
MAX_ROUNDS = 16  # chains are shorter than 2^16

HARNESS = DECODE_HARNESS + r"""
#include "decode_resolve.cuh"

namespace {
using snappy_resolve::kThreads;

// Who read and wrote each element of out[] and ptr[] since the last
// barrier: an element one thread reads or writes and another writes in the
// same phase is a race, whatever order the threads run in.
struct Races final : snappy_resolve::Watch {
  static constexpr int kNobody = -1, kSeveral = -2;
  const uint8_t* out = nullptr;
  const uint16_t* ptr = nullptr;
  std::vector<int32_t> writer = std::vector<int32_t>(2 * snappy_block::kBlockSize, kNobody);
  std::vector<int32_t> reader = std::vector<int32_t>(2 * snappy_block::kBlockSize, kNobody);
  std::vector<int32_t> touched;
  int thread = 0;
  int64_t found = 0;

  // out[] byte i is element i, ptr[] entry k element kBlockSize + k.
  void span(const void* p, size_t n, int32_t& first, int32_t& count) const {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    if (b >= out && b < out + snappy_block::kBlockSize) {
      first = static_cast<int32_t>(b - out);
      count = static_cast<int32_t>(n);
    } else {
      const size_t at = static_cast<size_t>(b - reinterpret_cast<const uint8_t*>(ptr));
      assert(at % 2 == 0 && n % 2 == 0 && at / 2 < snappy_block::kBlockSize);
      first = snappy_block::kBlockSize + static_cast<int32_t>(at / 2);
      count = static_cast<int32_t>(n / 2);
    }
  }
  void note(int32_t e) {
    if (writer[e] == kNobody && reader[e] == kNobody) touched.push_back(e);
  }
  void read(const void* p, size_t n) override {
    int32_t first, count;
    span(p, n, first, count);
    for (int32_t e = first; e < first + count; ++e) {
      note(e);
      if (writer[e] != kNobody && writer[e] != thread) ++found;
      reader[e] = reader[e] == kNobody || reader[e] == thread ? thread : kSeveral;
    }
  }
  void write(const void* p, size_t n) override {
    int32_t first, count;
    span(p, n, first, count);
    for (int32_t e = first; e < first + count; ++e) {
      note(e);
      if ((writer[e] != kNobody && writer[e] != thread) || (reader[e] != kNobody && reader[e] != thread)) ++found;
      writer[e] = thread;
    }
  }
  void barrier() {
    for (int32_t e : touched) writer[e] = reader[e] = kNobody;
    touched.clear();
  }
};

Races races;

struct HostBlock {  // decode_resolve.cuh's block policy: a phase's threads one after another
  template <class T>
  struct Var {
    T v[kThreads];
    T& operator[](int t) { return v[t]; }
    const T& operator[](int t) const { return v[t]; }
  };
  bool reverse;
  template <class F>
  void each(F f) {
    for (int i = 0; i < kThreads; ++i) {
      races.thread = reverse ? kThreads - 1 - i : i;
      f(races.thread);
    }
  }
  void sync() const { races.barrier(); }
  bool any(const Var<bool>& p) const {
    races.barrier();
    for (int t = 0; t < kThreads; ++t)
      if (p[t]) return true;
    return false;
  }
  int32_t min(const Var<int32_t>& x) const {
    races.barrier();
    int32_t m = x[0];
    for (int t = 1; t < kThreads; ++t) m = x[t] < m ? x[t] : m;
    return m;
  }
  int32_t excl_max_scan(Var<int32_t>& x) const {
    races.barrier();
    int32_t m = -1;
    for (int t = 0; t < kThreads; ++t) {
      const int32_t v = x[t];
      x[t] = m;
      m = v > m ? v : m;
    }
    return m;
  }
};

struct HostTapeFetch {
  const int32_t* tape;
  snappy_tape::Record operator()(int32_t r) const { return snappy_tape::decode_record(tape[2 * r], tape[2 * r + 1]); }
};

struct HostTapeWalk {  // K6's walk: decode_tape.cuh's run_tape over the whole image, lanes in reverse
  uint8_t* img;
  const uint8_t* row;
  const int32_t* tape;
  int64_t nrecs;
  int64_t cap;
  bool operator()() const {
    memset(img, 0, snappy_tape::kImageBytes);
    memcpy(img + snappy_tape::kCompOff, row, snappy_block::kPadOut);
    HostFetch fetch{tape};
    HostWarp move{img};
    return snappy_tape::run_tape(nrecs, cap, fetch, move);
  }
};

// The image and pointers start as garbage, as shared memory does; races
// watches them from a barrier on.
snappy_resolve::Image garbage_image() {
  alignas(16) static uint8_t out_s[snappy_block::kBlockSize];
  alignas(16) static uint16_t ptr_s[snappy_block::kBlockSize];
  memset(out_s, 0x5A, sizeof out_s);
  memset(ptr_s, 0xA5, sizeof ptr_s);
  races.out = out_s;
  races.ptr = ptr_s;
  races.barrier();
  snappy_resolve::Image im{out_s, ptr_s, nullptr};
  im.watch = &races;
  return im;
}
}  // namespace

// The races seen since the last call.
extern "C" int64_t resolve_races() {
  const int64_t n = races.found;
  races.found = 0;
  return n;
}

// The race watch itself: each thread stores its unit t, then loads unit
// t + 1, with or without a barrier between -> the races seen.
extern "C" int64_t neighbour_races(int barrier, int reverse) {
  const snappy_resolve::Image im = garbage_image();
  HostBlock blk{reverse != 0};
  races.found = 0;
  blk.each([&](int t) { snappy_resolve::store_unit(im, t, snappy_resolve::Unit{}); });
  if (barrier) blk.sync();
  blk.each([&](int t) {
    snappy_resolve::Unit x;
    snappy_resolve::load_unit(im, (t + 1) % kThreads, x);
  });
  blk.sync();
  return resolve_races();
}

// K6's kernel body on the host -> ok; *rounds as the kernel writes it.
extern "C" int resolve_tape_host(const int32_t* tape, int32_t nrecs, int32_t cap, const uint8_t* row, uint8_t* out,
                                 int reverse, int32_t* rounds) {
  static uint8_t img[snappy_tape::kImageBytes];
  snappy_resolve::Image im = garbage_image();
  im.row = row;
  HostBlock blk{reverse != 0};
  HostTapeFetch fetch{tape};
  HostTapeWalk walk{img, row, tape, nrecs, cap};
  const snappy_resolve::Outcome res = snappy_resolve::run_tape_block(blk, fetch, nrecs, cap, im, walk);
  memcpy(out, res.rounds == snappy_resolve::kWalked ? img + snappy_tape::kOutBase : im.out, snappy_block::kBlockSize);
  *rounds = res.rounds;
  return res.ok ? 1 : 0;
}

// K3's two launches on the host: K4a's parse with ctx_len 0 (K2's sizer
// and judge) into a record buffer, then the resolver -> ok; *rounds as
// resolve_blocks_kernel writes it.
extern "C" int resolve_blocks_host(const uint8_t* row, int32_t comp_len, int32_t out_len, uint8_t* out, int reverse,
                                   int32_t* rounds) {
  static uint8_t comp_s[snappy_block::kPadOut + snappy_pipe::kSlack];
  static Rec recs[snappy_block::kPadOut / 2];
  int64_t groups = 0;
  bool parsed = false;
  int32_t n = 0;
  if (0 <= comp_len && comp_len <= snappy_block::kPadOut && 0 <= out_len && out_len <= snappy_block::kBlockSize) {
    stage_row(comp_s, row, comp_len);
    PipeWarp w{&groups};
    PipeWindows windows;
    snappy_pipe::size_block(w, comp_s, comp_len, windows);
    RecordSink sink{recs};
    parsed = snappy_pipe::judge_block(w, comp_len, out_len, 0, windows, sink);
    n = sink.count;
  }
  snappy_resolve::Image im = garbage_image();
  im.row = row;  // the kernel reads literals from the unstaged row
  HostBlock blk{reverse != 0};
  const snappy_resolve::RecSpans spans{recs};
  const int r = snappy_resolve::resolve(blk, im, spans, n);
  memcpy(out, im.out, snappy_block::kBlockSize);
  *rounds = r;
  return parsed && r <= snappy_resolve::kMaxRounds ? 1 : 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("resolve_host")
    src, so = d / "harness.cc", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I32 = ctypes.c_void_p, ctypes.c_int32
    lib.resolve_tape_host.argtypes = [P, I32, I32, P, P, ctypes.c_int, P]
    lib.resolve_tape_host.restype = ctypes.c_int
    lib.resolve_blocks_host.argtypes = [P, I32, I32, P, ctypes.c_int, P]
    lib.resolve_blocks_host.restype = ctypes.c_int
    lib.resolve_races.restype = ctypes.c_int64
    lib.neighbour_races.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.neighbour_races.restype = ctypes.c_int64
    return lib


ORDERS = ["forward", "reverse"]


def _k6(lib, tapes, nrecs, rows, order):
    """K6's body on every block -> (rows, ok, rounds)."""
    tapes, rows = np.ascontiguousarray(tapes, np.int32), np.ascontiguousarray(rows)
    out = np.empty((rows.shape[0], BS), np.uint8)
    rounds = np.zeros(rows.shape[0], np.int32)
    ok = np.array([lib.resolve_tape_host(tapes[b].ctypes.data, int(nrecs[b]), tapes.shape[1] // 2, rows[b].ctypes.data,
                                         out[b].ctypes.data, order == "reverse", rounds[b:].ctypes.data)
                   for b in range(rows.shape[0])], bool)
    assert lib.resolve_races() == 0, "threads of one phase touched an element another wrote"
    return out, ok, rounds


def _k3(lib, rows, cl, ol, order):
    """K3's two launches on every block -> (rows, ok, rounds)."""
    rows = np.ascontiguousarray(rows)
    out = np.empty((rows.shape[0], BS), np.uint8)
    rounds = np.zeros(rows.shape[0], np.int32)
    ok = np.array([lib.resolve_blocks_host(rows[b].ctypes.data, int(cl[b]), int(ol[b]), out[b].ctypes.data,
                                           order == "reverse", rounds[b:].ctypes.data)
                   for b in range(rows.shape[0])], bool)
    assert lib.resolve_races() == 0, "threads of one phase touched an element another wrote"
    return out, ok, rounds


@pytest.mark.parametrize("order", ORDERS)
def test_race_watch_sees_a_missing_barrier(lib, order):
    """The watch itself: each thread writes its unit, then reads its
    neighbour's; without a barrier between, every read is a race (16
    elements a unit), with one none."""
    assert lib.neighbour_races(0, order == "reverse") == 16 * 1024
    assert lib.neighbour_races(1, order == "reverse") == 0


def _tape_plain(tapes, nrecs, rows):
    out, ok = decode_tape.run_tape_ref(torch.from_numpy(np.ascontiguousarray(tapes, np.int32)),
                                       torch.from_numpy(np.asarray(nrecs, np.int32)), torch.from_numpy(rows))
    return out.numpy(), ok.numpy()


def _distribution(what, rounds):
    values, counts = np.unique(rounds, return_counts=True)
    print(f"{what}: rounds {dict(zip(values.tolist(), counts.tolist()))}")


@functools.cache
def run_streams():
    """Blocks of long chains, JAX-encoded with both profiles: zero and
    constant blocks (a dist-1 run over the whole block), low entropy, the
    mixed corpus's runs, and the edge cases' 32 KiB of 0xFF."""
    edge = corpus.edge_case_corpus()
    data = [corpus.constant(BS, 0), corpus.constant(BS, 0xAB), corpus.low_entropy(BS, seed=31),
            corpus.mixed(BS, seed=32), edge["32k_ff"], edge["low_entropy_runs"][:BS]]
    blocks = np.zeros((len(data), BS), np.uint8)
    lens = np.array([len(d) for d in data], np.int32)
    for i, d in enumerate(data):
        blocks[i, : len(d)] = np.frombuffer(d, np.uint8)
    out = []
    for dense in (True, False):
        comp, totals = map(np.asarray, jax_encode(blocks, lens, dense))
        out += [(comp[i, : totals[i]].tobytes(), int(lens[i])) for i in range(len(data))]
    return out


def _chain_stream(period: int, size: int = BS):
    """A literal of `period` bytes, then COPY1s of 4 bytes at distance
    `period` up to `size` bytes: the longest chains a Snappy block makes,
    one hop per 4 bytes."""
    ops, n = bytearray(_lit(bytes(range(7, 7 + period)))), period
    while n + 4 <= size:
        ops += _copy1(4, period)
        n += 4
    return bytes(ops), n


K3_FAMILIES = {**FAMILIES, "runs": run_streams, "chains": lambda: [_chain_stream(p) for p in (1, 2, 3)]}


@functools.cache
def _k3_family(family):
    """(rows, comp_lens, out_lens, JAX decode_blocks_vm2 rows, flags, plain rows, flags)."""
    rows, cl, ol = _rows(K3_FAMILIES[family]())
    jout, jok = map(np.asarray, jax_vm2(rows, cl, ol))
    pout, pok = decode_vm4.decode_blocks_ref(*(torch.from_numpy(a) for a in (rows, cl, ol)))
    return rows, cl, ol, jout, jok, pout.numpy(), pok.numpy()


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("family", sorted(K3_FAMILIES))
def test_k3_resolver_equals_plain_and_jax_vm2(lib, family, order):
    rows, cl, ol, jout, jok, pout, pok = _k3_family(family)
    out, ok, rounds = _k3(lib, rows, cl, ol, order)
    np.testing.assert_array_equal(ok, pok, err_msg="ok vs plain")
    np.testing.assert_array_equal(ok, jok, err_msg="ok vs JAX decode_blocks_vm2")
    np.testing.assert_array_equal(out[ok], pout[ok], err_msg="rows vs plain")
    np.testing.assert_array_equal(out[ok], jout[ok], err_msg="rows vs JAX decode_blocks_vm2")
    assert 0 <= rounds.min() and rounds.max() <= MAX_ROUNDS
    if family in ("runs", "chains"):
        assert ok.all() and rounds.max() >= 8  # chains of hundreds of hops or more
    _distribution(f"K3 {family}", rounds)


@pytest.mark.parametrize("seed", range(3))
def test_k3_resolver_equals_plain_on_mutation_fuzz(lib, seed):
    """150 seeded mutations per seed (header and payload bytes, truncations,
    wrong out_lens), half with garbage past comp_len, the threads in
    reverse: flags equal everywhere, rows wherever ok."""
    rng = np.random.default_rng(1100 + seed)
    base = own_streams() + golden_streams() + run_streams()
    streams = []
    for _ in range(150):
        ops, n = base[int(rng.integers(0, len(base)))]
        arr = bytearray(ops)
        for _ in range(int(rng.integers(1, 4))):
            arr[int(rng.integers(0, len(arr)))] = int(rng.integers(0, 256))
        cut = len(arr) if rng.random() < 0.8 else int(rng.integers(0, len(arr) + 1))
        streams.append((bytes(arr[:cut]), n if rng.random() < 0.9 else int(rng.integers(0, BS + 1))))
    rows, cl, ol = _rows(streams)
    for i in range(0, rows.shape[0], 2):
        rows[i, cl[i]:] = rng.integers(0, 256, PAD_OUT - cl[i], dtype=np.uint8)
    out, ok, rounds = _k3(lib, rows, cl, ol, "reverse")
    pout, pok = decode_vm4.decode_blocks_ref(*(torch.from_numpy(a) for a in (rows, cl, ol)))
    np.testing.assert_array_equal(ok, pok.numpy())
    np.testing.assert_array_equal(out[ok], pout.numpy()[ok])
    assert 0 < ok.sum() < ok.size and rounds.max() <= MAX_ROUNDS


@pytest.mark.parametrize("name", sorted(HAND_CASES))
def test_k3_resolver_hand_cases(lib, name):
    """test_torch_decode_host.py's hand cases (fills, copies inside a batch,
    far copies, bad ops mid-batch, exact ends, long literals)."""
    rows, cl, ol = _rows(HAND_CASES[name]())
    out, ok, rounds = _k3(lib, rows, cl, ol, "forward")
    pout, pok = decode_vm4.decode_blocks_ref(*(torch.from_numpy(a) for a in (rows, cl, ol)))
    np.testing.assert_array_equal(ok, pok.numpy())
    np.testing.assert_array_equal(out[ok], pout.numpy()[ok])
    assert rounds.max() <= MAX_ROUNDS


def test_k3_refuses_lengths_out_of_range(lib):
    rows, cl, ol = _rows([(_lit(b"abc"), 3)] * 4)
    cl = np.array([-1, PAD_OUT + 1, 4, 4], np.int32)
    ol = np.array([3, 3, -1, BS + 1], np.int32)
    out, ok, rounds = _k3(lib, rows, cl, ol, "forward")
    assert not ok.any() and not out.any() and not rounds.any()  # no records: zero rows, no rounds


def _builder_tapes(rows, cl, ol):
    if not cpu.available:
        pytest.skip("the tape builder needs the native runtime")
    return decode_tape.build_tapes(rows, cl, ol)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("family", sorted(K3_FAMILIES))
def test_k6_resolver_equals_plain_on_builder_tapes(lib, family, order):
    """The builder's tapes of every family: rows and flags equal to the plain
    run_tape_ref on every block, equal to the JAX decoder's rows where ok,
    never the walk, never more than 16 rounds."""
    rows, cl, ol, jout, jok, _pout, _pok = _k3_family(family)
    tapes, nrecs = _builder_tapes(rows, cl, ol)
    out, ok, rounds = _k6(lib, tapes, nrecs, rows, order)
    pout, pok = _tape_plain(tapes, nrecs, rows)
    np.testing.assert_array_equal(ok, pok)
    np.testing.assert_array_equal(out, pout)
    np.testing.assert_array_equal(out[ok], jout[ok])
    assert (rounds >= 0).all(), "a builder tape took the walk"
    assert rounds.max() <= MAX_ROUNDS
    _distribution(f"K6 {family}", rounds)


@pytest.mark.parametrize("seed", range(3))
def test_k6_equals_plain_on_random_records(lib, seed):
    """Random records (overlapping copies, records leaving the image, dsts
    anywhere, nrecs outside [0, cap]): every flag and byte equal to the plain
    version, through the walk or, where no record runs out of order, the
    resolver."""
    rng = np.random.default_rng(600 + seed)
    tapes, nrecs = _random_tapes(rng, 48, 64)
    rows = rng.integers(0, 256, (48, PAD_OUT), dtype=np.uint8)
    out, ok, rounds = _k6(lib, tapes, nrecs, rows, "reverse")
    pout, pok = _tape_plain(tapes, nrecs, rows)
    np.testing.assert_array_equal(ok, pok)
    np.testing.assert_array_equal(out, pout)
    assert (rounds == -1).any() and (rounds >= 0).any()


def _output_tapes(rng, B: int, S: int):
    """Hand-made tapes inside the output region, in ascending order as the
    resolver needs, but of every kind the builder does not write: gaps
    between records, empty records, copies from the guard, the row, the
    output far back or just before, copies that read past their own end,
    fills of period 1, 2 and 4 at the region's first byte.  Then, by block:
    b % 5 == 1 one record refused (an overlapping copy), b % 5 == 2 one
    record behind the one before (out of order: the walk), b % 5 == 3 the
    first record below the output region (the walk), b % 5 == 4 nrecs past
    the tape's capacity."""
    img, base = decode_tape.IMAGE_BYTES, decode_tape.OUT_BASE
    tapes = np.zeros((B, S, 2), np.int64)
    nrecs = np.zeros(B, np.int32)
    for b in range(B):
        dst = base + int(rng.integers(0, 3)) * int(rng.integers(0, 40))
        for r in range(S):
            ln = int((rng.integers(0, 9), rng.integers(9, 100), rng.integers(100, decode_tape.PIECE_MAX + 1))[r % 3])
            if dst + ln > img:
                break
            kind = rng.random()
            if kind < 0.25:
                pk2, src = int(rng.integers(1, 4)), 0
            else:
                pk2 = 0
                where = rng.random()
                if where < 0.15:
                    src = int(rng.integers(0, decode_tape.COMP_OFF))  # the guard, maybe into the row
                elif where < 0.4:
                    src = int(rng.integers(decode_tape.COMP_OFF, base - ln))  # the row
                elif where < 0.55 and dst + 2 * ln < img:
                    src = int(rng.integers(dst + ln, img - ln + 1))  # past its own end: zeros
                else:
                    src = int(rng.integers(base - ln, dst - ln + 1))  # the output before it, or the row's end
            tapes[b, r] = (src | pk2 << 18 | ln << 20, dst)
            nrecs[b] = r + 1
            dst += ln + (int(rng.integers(1, 30)) if rng.random() < 0.2 else 0)
        k = int(rng.integers(1, min(nrecs[b], 10)))
        if b % 5 == 1:
            tapes[b, k, 0] = (tapes[b, k, 1] - 10) | 100 << 20  # overlapping: refused
        elif b % 5 == 2:
            tapes[b, k] = (1 << 18 | 50 << 20, tapes[b, k - 1, 1] - 1)  # a fill behind the record before it
        elif b % 5 == 3:
            tapes[b, 0, 1] = base - 300
            tapes[b, 0, 0] = 600 | 200 << 20
        elif b % 5 == 4:
            nrecs[b] = S + 1
    w0 = tapes[..., 0].astype(np.uint32).view(np.int32)
    return np.stack([w0, tapes[..., 1].astype(np.int32)], -1).reshape(B, 2 * S), nrecs


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("seed", range(3))
def test_k6_resolver_on_hand_made_output_tapes(lib, seed, order):
    """_output_tapes: every flag and byte equal to the plain version; the
    ascending tapes resolve (refused records cut them, nrecs past the
    capacity runs none), the out-of-order ones take the walk."""
    rng = np.random.default_rng(1200 + seed)
    B, S = 40, 120
    tapes, nrecs = _output_tapes(rng, B, S)
    rows = rng.integers(0, 256, (B, PAD_OUT), dtype=np.uint8)
    out, ok, rounds = _k6(lib, tapes, nrecs, rows, order)
    pout, pok = _tape_plain(tapes, nrecs, rows)
    np.testing.assert_array_equal(ok, pok)
    np.testing.assert_array_equal(out, pout)
    kind = np.arange(B) % 5
    assert ok[kind == 0].all() and not ok[(kind == 1) | (kind == 4)].any()
    walked = rounds == -1
    assert walked[(kind == 2) | (kind == 3)].all() and not walked[(kind == 0) | (kind == 1) | (kind == 4)].any()
    assert rounds.max() <= MAX_ROUNDS
    assert out[kind == 0].any(axis=1).all()


def _one_byte_fills(n: int, empty: int = 0):
    """A tape of n fill records of one byte and period 1 from the output
    region's second byte, then `empty` empty records at its end: byte j's
    chain runs down to byte 0, never written."""
    dst = decode_tape.OUT_BASE + 1 + np.minimum(np.arange(n + empty, dtype=np.int64), n)
    w0 = np.where(np.arange(n + empty) < n, 1 << 18 | 1 << 20, 1 << 18).astype(np.int64)
    return np.stack([w0.astype(np.int32), dst.astype(np.int32)], -1).reshape(1, 2 * (n + empty))


@pytest.mark.parametrize("n, empty", [(1000, 0), (65534, 0), (65535, 0), (65535, 1)])
def test_k6_longest_chains(lib, n, empty):
    """The longest chains a block holds: about log2(n) rounds for n
    one-byte fills, 16 for 65,535 of them; a tape of more records than
    the marks can index (65,536, the last one empty) takes the walk."""
    tape = _one_byte_fills(n, empty)
    rows = np.zeros((1, PAD_OUT), np.uint8)
    rows[0, -1] = 7  # the row's last byte, which the first fill... never reads: byte 0 of the output stays zero
    nrecs = np.array([n + empty], np.int32)
    out, ok, rounds = _k6(lib, tape, nrecs, rows, "forward")
    pout, pok = _tape_plain(tape, nrecs, rows)
    np.testing.assert_array_equal(out, pout)
    np.testing.assert_array_equal(ok, pok)
    assert ok[0]
    if n + empty > 65535:
        assert rounds[0] == -1
    else:
        full = int(np.ceil(np.log2(n + 1)))  # chains of up to n hops
        print(f"K6 {n} one-byte fills: {rounds[0]} rounds ({full} for chains of {n} hops)")
        assert full - 1 <= rounds[0] <= full <= MAX_ROUNDS
