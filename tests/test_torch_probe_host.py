"""The probes' bodies, checked from their own source without a GPU.

snappytpu_torch/csrc/anatomy.cuh holds the movers of T2's variants
(dec_anatomy.cu, on K2's sizer -> judge -> mover pipeline) and T3's modes
(tape_probe.cu, on K5's producer -> mover), and T3's record loads.  It is
host+device code: here g++ builds it, with decode_pipe.cuh's sizer and
judge and decode_tape.cuh's producer, under the host warp policy of
test_torch_decode_host.py (PipeWarp: the 32 lanes one by one, in reverse,
so that an order-dependent move would show), each batch handed to the
mover as the producer hands it over:
  * T2: every variant against the plain walk `walk_ref` (image, ok, final
    cursor, fold) on test_torch_decode.py's rows, test_torch_dec_anatomy.py's
    batch, a seeded mutation fuzz with garbage past comp_len, and fills at
    distances 1, 2 and 4 that move_batch joins (fixed must not);
  * T3: every mode against its plain version (`probe_ref`, the exact modes
    `run_tape_ref`) on builder tapes of those rows,
    test_torch_tape_probe.py's batch, `hazard_batch()`, forward tapes whose
    records read what their batch just wrote (rowbatch resolves those by
    address) and random tapes.
Tolerance: exact.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from snappytpu.format import constants as C
from snappytpu_torch import _build, cpu
from snappytpu_torch.kernels import decode_tape
from snappytpu_torch.tools import dec_anatomy, tape_probe
from test_torch_dec_anatomy import _batch as anatomy_batch
from test_torch_decode import FAMILIES, _rows, decoded, golden_streams, own_streams
from test_torch_decode_host import HARNESS, HAND_CASES, _forward_tapes, _garbage_tail, _random_tapes
from test_torch_tape_probe import _batch as probe_batch

torch.set_num_threads(1)  # the CPU tests run as several worker processes side by side

PROBES = r"""
#include "anatomy.cuh"

namespace {
using snappy_anat::Rec;
constexpr int32_t kOut = snappy_block::kPadOut + snappy_pipe::kSlack;  // dec_anatomy.cu's: the image after the row

// Each batch as the producer hands it over, straight to mv(w, rec, n).
template <class Mover>
struct ProbeSink {
  PipeWarp& w;
  Mover& mv;
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
    mv(w, rec, count);
    ++*batches;
    count = 0;
  }
};

// T2's mover of variant v over the flat smem of dec_anatomy.cu: the staged
// row, then the image.
struct AnatomyMover {
  int v;
  uint8_t* base;
  int32_t end = 0;
  snappy_anat::Fold fold{nullptr};
  snappy_anat::Covered fixed{nullptr};
  void operator()(PipeWarp& w, PipeWarp::Var<Rec>& rec, int n) {
    end = snappy_anat::batch_end(w, rec, n, end);
    if (v == 1) snappy_anat::move_batch_as(w, rec, n, true, snappy_anat::K2Place{0, kOut}, fold);
    if (v == 2) snappy_pipe::move_batch(w, rec, n, base, base + kOut);
    if (v == 3) snappy_anat::move_batch_as(w, rec, n, false, snappy_anat::FixedPlace{0, kOut}, fixed);
  }
};
}  // namespace

// T2's kernel body on the host: stats = {batches, groups}.
extern "C" int anatomy_host(int v, const uint8_t* row, int32_t cl, int32_t ol, uint8_t* out, int32_t* opc,
                            uint32_t* fold, int64_t* stats) {
  static uint8_t smem[kOut + snappy_block::kBlockSize];
  memset(smem, 0xA5, sizeof smem);
  const bool valid = 0 <= cl && cl <= snappy_block::kPadOut && 0 <= ol && ol <= snappy_block::kBlockSize;
  int nrow = valid ? (cl + 15) / 16 : 0;
  if (v == 3 && valid && nrow < (snappy_anat::kFixedSrc + ol + 15) / 16) nrow = (snappy_anat::kFixedSrc + ol + 15) / 16;
  memcpy(smem, row, 16 * nrow);
  memset(smem + 16 * nrow, 0, snappy_pipe::kSlack);
  memset(smem + kOut, 0, snappy_block::kBlockSize);
  AnatomyMover mv{v, smem};
  mv.fold.base = smem;
  mv.fixed.base = smem;
  bool good = false;
  if (valid) {
    PipeWarp w{&stats[1]};
    PipeWindows windows;
    snappy_pipe::size_block(w, smem, cl, windows);
    ProbeSink<AnatomyMover> sink{w, mv, &stats[0]};
    good = snappy_pipe::judge_block(w, cl, ol, 0, windows, sink);
  }
  memcpy(out, smem + kOut, snappy_block::kBlockSize);
  *opc = mv.end;
  *fold = mv.fold.acc ^ mv.fixed.acc;
  return good ? 1 : 0;
}

namespace {
constexpr int64_t kExtra = 2048;  // tape_probe.cu's, beside the image

// T3's mover of mode m (tape_probe.py's index) over tape_probe.cu's image.
struct TapeMover {
  int m, k;
  uint8_t* img;
  const int32_t* stash;
  uint32_t fold = 0;
  int32_t taken = 0;
  snappy_anat::Covered scratch{nullptr};
  snappy_anat::Window win{nullptr, nullptr, 0, 0};
  void operator()(PipeWarp& w, PipeWarp::Var<Rec>& rec, int n) {
    snappy_anat::Plain plain{img};
    if (m == 0 || m == 1) snappy_pipe::move_batch(w, rec, n, img, img);
    if (m == 2)
      for (int l = 31; l >= 0; --l) fold ^= snappy_anat::fold_stashed(stash, taken, n, l);
    if (m == 3) snappy_anat::move_batch_as(w, rec, n, false, snappy_anat::ScratchPlace{static_cast<int32_t>(snappy_tape::kImageBytes)}, scratch);
    if (m == 4) snappy_anat::move_batch_as(w, rec, n, true, snappy_anat::ImagePlace{}, win);
    if (m == 5 && k == 2) snappy_anat::move_batch_rows<2>(w, rec, n, plain);
    if (m == 5 && k == 4) snappy_anat::move_batch_rows<4>(w, rec, n, plain);
    if (m == 5 && k == 8) snappy_anat::move_batch_rows<8>(w, rec, n, plain);
    taken += n;
  }
};
}  // namespace

// T3's kernel body on the host: aux gets 128 words, stats = {batches, groups}.
extern "C" int probe_host(int m, int k, const int32_t* tape, int64_t nrecs, int64_t cap, const uint8_t* row,
                          uint8_t* out, int32_t* aux, int64_t* stats) {
  static uint8_t img[snappy_tape::kImageBytes + kExtra + 16];  // a word move may read a word past its source
  static int32_t ring[2 * 32 * 3];
  memset(img, 0, sizeof img);
  memcpy(img + snappy_tape::kCompOff, row, snappy_block::kPadOut);
  uint8_t* extra = img + snappy_tape::kImageBytes;
  TapeMover mv{m, k, img, reinterpret_cast<const int32_t*>(extra)};
  mv.scratch.base = img;
  mv.win = snappy_anat::Window{img, extra, static_cast<int32_t>(snappy_tape::kImageBytes / 512), 0};
  bool good = false;
  if (0 <= nrecs && nrecs <= cap) {
    PipeWarp w{&stats[1]};
    if (m == 4) mv.win.load(w, static_cast<int32_t>(snappy_tape::kOutBase / 512));
    ProbeSink<TapeMover> sink{w, mv, &stats[0]};
    const int32_t nr = static_cast<int32_t>(nrecs);
    if (m == 1) {
      snappy_anat::AheadLoad<3> load{tape, nr, ring};
      good = snappy_tape::produce_tape(w, nr, load, sink);
    } else if (m == 2) {
      snappy_anat::StashLoad load{tape, nr, reinterpret_cast<int32_t*>(extra)};
      good = snappy_tape::produce_tape(w, nr, load, sink);
    } else {
      TapeLoad load{tape, nr};
      good = snappy_tape::produce_tape(w, nr, load, sink);
    }
    if (m == 4) mv.win.flush(w);
  }
  memcpy(out, img + snappy_tape::kOutBase, snappy_block::kBlockSize);
  for (int i = 0; i < 128; ++i) {
    int32_t s;
    memcpy(&s, extra + 4 * i, 4);
    aux[i] = m == 3 ? s : (m == 2 && i == 0 ? static_cast<int32_t>(mv.fold) : 0);
  }
  return good ? 1 : 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("probe_host")
    src, so = d / "harness.cc", d / "libprobes.so"
    src.write_text(HARNESS + PROBES)
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.anatomy_host.argtypes = [I, P, ctypes.c_int32, ctypes.c_int32, P, P, P, P]
    lib.anatomy_host.restype = I
    lib.probe_host.argtypes = [I, I, P, I64, I64, P, P, P, P]
    lib.probe_host.restype = I
    return lib


def _anatomy(lib, variant, rows, cl, ol):
    """T2's body on the host -> (image, ok, opc, fold) numpy arrays and
    {batches, groups}."""
    rows = np.ascontiguousarray(rows)
    B = rows.shape[0]
    img = np.empty((B, C.MAX_BLOCK_SIZE), np.uint8)
    opc = np.zeros(B, np.int32)
    fold = np.zeros(B, np.uint32)
    stats = np.zeros(2, np.int64)
    v = dec_anatomy.VARIANTS.index(variant)
    ok = np.array([lib.anatomy_host(v, rows[b].ctypes.data, int(cl[b]), int(ol[b]), img[b].ctypes.data,
                                    opc[b:].ctypes.data, fold[b:].ctypes.data, stats.ctypes.data)
                   for b in range(B)], bool)
    return (img, ok, opc, fold.view(np.int32)), {"batches": int(stats[0]), "groups": int(stats[1])}


def _mutated(seed: int, n: int = 60):
    """Seeded mutations of test_torch_decode.py's streams (header and
    payload bytes, cuts, wrong out_lens), half with garbage past comp_len."""
    rng = np.random.default_rng(1200 + seed)
    base = own_streams() + golden_streams()
    streams = []
    for _ in range(n):
        ops, size = base[int(rng.integers(0, len(base)))]
        arr = bytearray(ops)
        for _ in range(int(rng.integers(1, 4))):
            arr[int(rng.integers(0, len(arr)))] = int(rng.integers(0, 256))
        cut = len(arr) if rng.random() < 0.8 else int(rng.integers(0, len(arr) + 1))
        streams.append((bytes(arr[:cut]), size if rng.random() < 0.9 else int(rng.integers(0, C.MAX_BLOCK_SIZE + 1))))
    rows, cl, ol = _rows(streams)
    rows[::2] = _garbage_tail(rows[::2], cl[::2], rng)
    return rows, cl, ol


def _fills():
    """Fills at distances 1, 2 and 4 (and the three in turn): runs of copies
    at one distance, which move_batch joins into one record; fixed must keep
    each op's bytes, the last op's winning."""
    streams = [s for name in ("fill_1", "fill_2", "fill_4", "fill_1_2_4") for s in HAND_CASES[name]()]
    return _rows(streams)


ANATOMY_SETS = {
    **{f"family_{f}": functools.partial(lambda f: decoded(f)[:3], f) for f in sorted(FAMILIES)},
    "dec_anatomy_batch": anatomy_batch,
    "mutated_0": functools.partial(_mutated, 0),
    "mutated_1": functools.partial(_mutated, 1),
    "fills": _fills,
}


@functools.cache
def _anatomy_ref(name):
    rows, cl, ol = ANATOMY_SETS[name]()
    ref = dec_anatomy.walk_ref(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (rows, cl, ol)))
    return (rows, cl, ol), {v: [t.numpy() for t in r] for v, r in ref.items()}


@pytest.mark.parametrize("variant", dec_anatomy.VARIANTS)
@pytest.mark.parametrize("name", sorted(ANATOMY_SETS))
def test_anatomy_variant_equals_walk_ref(lib, name, variant):
    (rows, cl, ol), ref = _anatomy_ref(name)
    got, stats = _anatomy(lib, variant, rows, cl, ol)
    for what, g, r in zip(("image", "ok", "opc", "fold"), got, ref[variant]):
        np.testing.assert_array_equal(g, r, err_msg=f"{name} {variant}: {what}")
    if name == "fills" and variant == "fixed":  # unjoined, each fill reads the one before: a group each
        assert stats["groups"] > _anatomy(lib, "full", rows, cl, ol)[1]["groups"]
    if name.startswith("mutated"):
        assert 0 < got[1].sum() < got[1].size


def test_fixed_fills_keep_the_last_op():
    """The fills' fixed image is each position's last op: with joining a run
    of copies at one distance would read j % dist across ops (a different
    image); walk_ref itself is checked here on one fill against a direct
    per-op replay."""
    rows, cl, ol = _fills()
    ref = dec_anatomy.walk_ref(*(torch.from_numpy(a) for a in (rows, cl, ol)))["fixed"][0].numpy()
    row = rows[0].tobytes()
    src = np.frombuffer(row, np.uint8)[64:]
    want = np.zeros(C.MAX_BLOCK_SIZE, np.uint8)
    ip, opc = 0, 0
    while opc < ol[0]:
        hdr, ln, d, bad = dec_anatomy._parse_at(row, ip, opc, int(cl[0]), int(ol[0]))
        assert not bad
        want[:ln] = src[np.arange(ln) % d] if 0 < d < ln else src[:ln]
        ip += hdr + (ln if d == 0 else 0)
        opc += ln
    np.testing.assert_array_equal(ref[0], want)


def _probe(lib, mode, tapes, nrecs, rows):
    """T3's body on the host -> (out, ok, aux) numpy arrays and {batches,
    groups}."""
    tapes, rows = np.ascontiguousarray(tapes, np.int32), np.ascontiguousarray(rows)
    B = rows.shape[0]
    out = np.empty((B, C.MAX_BLOCK_SIZE), np.uint8)
    aux = np.zeros((B, tape_probe.AUX), np.int32)
    stats = np.zeros(2, np.int64)
    m, k = tape_probe._mode(mode)
    ok = np.array([lib.probe_host(m, k, tapes[b].ctypes.data, int(nrecs[b]), tapes.shape[1] // 2, rows[b].ctypes.data,
                                  out[b].ctypes.data, aux[b].ctypes.data, stats.ctypes.data) for b in range(B)], bool)
    return (out, ok, aux), {"batches": int(stats[0]), "groups": int(stats[1])}


def _builder_tapes(family):
    rows, cl, ol = decoded(family)[:3]
    tapes, nrecs = decode_tape.build_tapes(rows, cl, ol)
    return tapes, nrecs, rows


def _seeded(make, seed, B, S):
    rng = np.random.default_rng(seed)
    tapes, nrecs = make(rng, B, S)
    return tapes, nrecs, rng.integers(0, 256, (B, C.MAX_COMPRESSED_BLOCK_SIZE), dtype=np.uint8)


PROBE_SETS = {
    **{f"family_{f}": functools.partial(_builder_tapes, f) for f in sorted(FAMILIES)},
    "tape_probe_batch": probe_batch,
    "hazard_batch": tape_probe.hazard_batch,
    "forward": functools.partial(_seeded, _forward_tapes, 1800, 24, 96),
    "random": functools.partial(_seeded, _random_tapes, 1900, 24, 64),
}


@functools.cache
def _probe_ref(name, mode):
    """The set and its plain outputs: K5's plain walk and zero aux for the
    exact modes (computed once a set), probe_ref for the others."""
    tapes, nrecs, rows = _probe_set(name)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (tapes, nrecs, rows))
    if mode in tape_probe.EXACT and mode != "full-D1":
        return (tapes, nrecs, rows), _probe_ref(name, "full-D1")[1]
    return (tapes, nrecs, rows), [t.numpy() for t in tape_probe.probe_ref(mode, *args)]


@functools.cache
def _probe_set(name):
    return PROBE_SETS[name]()


@pytest.mark.parametrize("mode", tape_probe.MODES)
@pytest.mark.parametrize("name", sorted(PROBE_SETS))
def test_probe_mode_equals_plain(lib, name, mode):
    if not cpu.available:
        pytest.skip("the tape builder needs the native runtime")
    (tapes, nrecs, rows), ref = _probe_ref(name, mode)
    got, stats = _probe(lib, mode, tapes, nrecs, rows)
    for what, g, r in zip(("out", "ok", "aux"), got, ref):
        np.testing.assert_array_equal(g, r, err_msg=f"{name} {mode}: {what}")
    if name == "forward" and mode in ("rowbatch2", "rowbatch8"):  # fewer, or more, syncs than K5's cut
        k5 = _probe(lib, "full-D1", tapes, nrecs, rows)[1]
        assert stats["batches"] == k5["batches"] and stats["groups"] != k5["groups"]
