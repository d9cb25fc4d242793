"""K1's header, checked from its own source without a GPU.

snappytpu_torch/csrc/concat.cuh holds the kernel's body: the clamped scan of
a row's lengths, the window -> section search and the shifted, masked gather
of one 16-byte window, with a tile's short sections staged.  Here
g++ builds it into a host harness that runs every (row, tile, thread)
window of a batch as the kernel's grid cuts it, each step of a block (start
the windows, stage the tile's sections, end the windows) over its threads in reverse
order, the scan under a host warp policy that runs the 32 lanes one after
another.  The rows are held byte for byte against the plain
version and, within the contract, against the JAX
`concat_rows_words` (Pallas interpret mode), at the encoder's shape (64
sections of 384 words into 73728-byte rows), at its other section counts
(16, 32 and 128 sections of 5632, 3072 and 1024 bytes) and at a small one
(5 sections of 128 words into 1536-byte rows).  The harness's source load fails the test on
any read outside the cap bytes of the section it is read for, on any word
that starts at or past that section's clamped length, and on any word that
holds no byte of the window it is read for below the row's total (so a
window past the total reads nothing), or for a staged section, of the
block's tile; every byte of a row must be written
exactly once.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from snappytpu.kernels.concat import concat_rows_words as jax_concat
from snappytpu_torch import _build
from snappytpu_torch.kernels import concat

HARNESS = r"""
#include <string.h>
#include <algorithm>
#include <vector>
#include "concat.cuh"

namespace {
using snappy_concat::Word;

struct HostWarp {  // concat.cuh's warp policy, the 32 lanes one by one, in reverse
  template <class T>
  struct Var {
    T v[32];
    T& operator[](int l) { return v[l]; }
    const T& operator[](int l) const { return v[l]; }
  };
  template <class F>
  void each(F f) {
    for (int l = 31; l >= 0; --l) f(l);
  }
  void excl_scan(Var<int32_t>& x) const {
    int32_t s = 0;
    for (int l = 0; l < 32; ++l) {
      const int32_t v = x[l];
      x[l] = s;
      s += v;
    }
  }
  int32_t shfl(const Var<int32_t>& x, int src) const { return x[src]; }
};

// The kernel's source load, checked.  stats[0] counts the words read,
// stats[1] the bad ones: outside the cap bytes of section s, starting at or
// past its clamped length, or holding no byte of the window (or, for a
// staged section, the tile) it is read for below min(row total, out_cap):
// row bytes [from, to).
struct CheckedLoad {
  const uint8_t* row;
  const int32_t* off;
  int32_t S;
  int32_t cap;
  int32_t from, to;
  int64_t* stats;
  Word operator()(int32_t s, int32_t k) const {
    Word w{{0u, 0u, 0u, 0u}};
    ++stats[0];
    const int64_t lo = 16LL * k;
    bool ok = 0 <= s && s < S && 0 <= lo && lo + 16 <= cap && lo < off[s + 1] - off[s];
    if (ok) {
      const int64_t a = off[s] + lo, e = std::min<int64_t>(a + 16, off[s + 1]);
      ok = a < to && e > from;
    }
    if (!ok) {
      ++stats[1];
      return w;
    }
    memcpy(w.x, row + static_cast<int64_t>(s) * cap + lo, 16);
    return w;
  }
};
}  // namespace

extern "C" int32_t concat_tile() { return snappy_concat::kTile; }

// K1's grid on the host, each step of a block over its threads in reverse
// order: stats = {words read, bad reads (and tiles staged in a row counted
// as without short sections), windows, row bytes not written exactly once,
// tiles that were staged}.
extern "C" void concat_host(const uint8_t* pieces, const int32_t* lens, uint8_t* out, int32_t B, int32_t S,
                            int32_t cap, int32_t out_cap, int64_t* stats) {
  using snappy_concat::kThreads;
  std::vector<int32_t> off(S + 2);
  std::vector<int32_t> writes(out_cap);
  std::vector<uint32_t> stage(snappy_concat::kTile / 4);
  std::vector<snappy_concat::Window> win(kThreads);
  const int32_t tiles = (out_cap + snappy_concat::kTile - 1) / snappy_concat::kTile;
  for (int32_t b = 0; b < B; ++b) {
    HostWarp w;
    snappy_concat::scan_lengths(w, lens + static_cast<int64_t>(b) * S, S, cap, off.data());
    std::fill(writes.begin(), writes.end(), 0);
    const uint8_t* row = pieces + static_cast<int64_t>(b) * S * cap;
    for (int32_t tile = 0; tile < tiles; ++tile) {
      for (int32_t t = kThreads - 1; t >= 0; --t) {
        const int32_t p = snappy_concat::window_start(tile, t);
        const CheckedLoad load{row, off.data(), S, cap, p, std::min({p + 16, off[S], out_cap}), stats};
        win[t] = snappy_concat::begin_window(load, off.data(), S, out_cap, p);
      }
      std::fill(stage.begin(), stage.end(), 0xEEEEEEEEu);  // bytes no section stages are never read
      if (std::any_of(win.begin(), win.end(), [](const snappy_concat::Window& x) { return x.more; })) {
        stats[1] += off[S + 1] == 0;  // a window of three sections in a row without a short one
        const snappy_concat::TileSections ts = snappy_concat::tile_sections(off.data(), S, out_cap, tile);
        const int32_t t0 = snappy_concat::window_start(tile, 0);
        const CheckedLoad tile_load{row, off.data(), S, cap, t0,
                                    std::min({t0 + snappy_concat::kTile, off[S], out_cap}), stats};
        for (int32_t t = kThreads - 1; t >= 0; --t) {
          snappy_concat::stage_sections(tile_load, off.data(), S, ts, t, reinterpret_cast<uint8_t*>(stage.data()));
        }
        ++stats[4];
      }
      for (int32_t t = kThreads - 1; t >= 0; --t) {
        const int32_t p = snappy_concat::window_start(tile, t);
        if (p >= out_cap) continue;
        const Word v = snappy_concat::end_window(win[t], stage.data(), snappy_concat::window_start(tile, 0), p);
        memcpy(out + static_cast<int64_t>(b) * out_cap + p, v.x, 16);
        for (int j = 0; j < 16; ++j) ++writes[p + j];
        ++stats[2];
      }
    }
    for (int32_t i = 0; i < out_cap; ++i) stats[3] += writes[i] != 1;
  }
}

// One checked read of a row whose section 0 holds len of its cap bytes and
// section 1 none, for a window whose bytes below the total are row bytes
// [from, to) -> bad reads (0 or 1).
extern "C" int64_t checked_read(int32_t cap, int32_t len, int32_t s, int32_t k, int32_t from, int32_t to) {
  std::vector<uint8_t> row(2 * static_cast<size_t>(cap));
  const int32_t off[3] = {0, len, len};
  int64_t stats[2] = {0, 0};
  const CheckedLoad load{row.data(), off, 2, cap, from, to, stats};
  load(s, k);
  return stats[1];
}
"""

# S, words per section, out_cap: the encoder's default shape, a small one, and
# the emit's other section counts with their capacities (_section_capacity:
# 5632, 3072 and 1024 bytes at 16, 32 and 128 sections)
SHAPES = {"main": (64, 384, 73728), "small": (5, 128, 1536),
          "s16": (16, 1408, 73728), "s32": (32, 768, 73728), "s128": (128, 256, 73728)}
B = 3


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("concat_host")
    src, so = d / "harness.cc", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I32 = ctypes.c_void_p, ctypes.c_int32
    lib.concat_host.argtypes = [P, P, P, I32, I32, I32, I32, P]
    lib.concat_host.restype = None
    lib.concat_tile.argtypes = []
    lib.concat_tile.restype = I32
    lib.checked_read.argtypes = [I32, I32, I32, I32, I32, I32]
    lib.checked_read.restype = ctypes.c_int64
    return lib


def _sum_to(rng, S, cap, target):
    """S lengths in [0, cap] summing to target: an even split, then bytes
    moved between random pairs."""
    ln = np.full(S, target // S, np.int64)
    ln[: target % S] += 1
    for _ in range(4 * S):
        i, k = rng.integers(0, S, 2)
        if i != k:
            x = int(rng.integers(0, min(ln[i], cap - ln[k]) + 1))
            ln[i] -= x
            ln[k] += x
    return ln


def _straddle(rng, S, cap, out_cap, unit=512):
    """Lengths whose sections end within 15 bytes of a multiple of 512 (a
    warp's stores; every tile edge is one), before or after it, so that
    sections straddle warp and tile edges at every phase."""
    ln = np.zeros(S, np.int64)
    cur = 0
    for s in range(S):
        edge = (cur // unit + 1) * unit
        j = int(rng.integers(1, 16)) * (1 if rng.random() < 0.5 else -1)
        end = edge + j if edge + j > cur else edge + unit + j
        if end > out_cap:
            break
        ln[s] = min(end - cur, cap)
        cur += ln[s]
    return ln


def _lens(kind, rng, S, cap, out_cap):
    """(B, S) lengths: test_torch_concat.py's six kinds, chip_smoke.py phase
    3's edge sets ("broken" outside the contract), and empty sections among
    one- and two-byte ones ("one_gaps")."""
    if kind == "zero":
        return np.zeros((B, S), np.int32)
    if kind == "full":  # sections at capacity until the row is full: out_cap exactly
        ln = np.zeros((B, S), np.int32)
        ln[:, : out_cap // cap] = cap
        return ln
    if kind == "one":  # every section 1 byte: 16 sections per window
        return np.ones((B, S), np.int32)
    if kind == "one_gaps":  # 1-, 2- and 0-byte sections: many sections per window, empty ones between
        return ((np.arange(S)[None, :] + np.arange(B)[:, None]) % 3 * (np.arange(S) % 2 + 1)).astype(np.int32)
    if kind == "odd":
        return (2 * rng.integers(0, min(cap, out_cap // S) // 2, (B, S)) + 1).astype(np.int32)
    if kind == "near_cap":  # rows 3 bytes short of out_cap
        return np.stack([_sum_to(rng, S, cap, out_cap - 3) for _ in range(B)]).astype(np.int32)
    if kind == "random":
        return (rng.integers(0, cap + 1, (B, S)) // 2).astype(np.int32)
    if kind == "random_cap":  # up to cap, each row drawn again until it fits out_cap
        rows = []
        while len(rows) < B:
            ln = rng.integers(0, cap + 1, S)
            if ln.sum() <= out_cap:
                rows.append(ln)
        return np.stack(rows).astype(np.int32)
    if kind == "edges":  # 16k - 1, 16k, 16k + 1 around every 16-byte boundary
        k = 1 + (np.arange(S)[None, :] * 5 + np.arange(B)[:, None] * 3) % (min(cap, out_cap // S) // 16 - 1)
        return (16 * k + (np.arange(S)[None, :] + np.arange(B)[:, None]) % 3 - 1).astype(np.int32)
    if kind == "straddle":
        return np.stack([_straddle(rng, S, cap, out_cap) for _ in range(B)]).astype(np.int32)
    if kind == "exact":  # rows summing exactly to out_cap: two random splits, an even one
        return np.stack([_sum_to(rng, S, cap, out_cap), _sum_to(rng, S, cap, out_cap),
                         np.full(S, out_cap // S) + (np.arange(S) < out_cap % S)]).astype(np.int32)
    assert kind == "broken"  # negative, above cap, extreme, rows past out_cap
    ln = rng.integers(-2 * cap, 2 * cap, (B, S)).astype(np.int32)
    ln[0, :2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    ln[1] = cap
    ln[2] = rng.integers(out_cap // S, 2 * cap, S)
    return ln


KINDS = ["zero", "full", "one", "odd", "near_cap", "random", "edges", "straddle", "exact", "broken", "one_gaps",
         "random_cap"]


@functools.cache
def _inputs(shape, kind):
    S, capw, out_cap = SHAPES[shape]
    rng = np.random.default_rng(100 * list(SHAPES).index(shape) + KINDS.index(kind))
    words = rng.integers(-2**31, 2**31, (B, S, capw), dtype=np.int64).astype(np.int32)
    lens = _lens(kind, rng, S, 4 * capw, out_cap)
    return words, lens, out_cap


def _in_contract(lens, cap, out_cap):
    return bool((lens >= 0).all() and (lens <= cap).all() and (lens.astype(np.int64).sum(1) <= out_cap).all())


def _staged_tiles(lens, cap, out_cap, tile):
    """The (row, tile) pairs with a window that three or more sections
    reach, below min(row total, out_cap): the tiles that need a stage."""
    n = 0
    for ln in np.clip(lens.astype(np.int64), 0, cap):
        off = np.cumsum(ln) - ln
        count = np.zeros(out_cap // 16 + 1, np.int64)  # sections per window, by a difference array
        for o, l in zip(off[ln > 0], ln[ln > 0]):
            count[min(o // 16, out_cap // 16)] += 1
            count[min((o + l - 1) // 16 + 1, out_cap // 16)] -= 1
        windows = np.nonzero(np.cumsum(count)[: out_cap // 16] >= 3)[0]
        n += len(np.unique(windows * 16 // tile))
    return n


def _run(lib, words, lens, out_cap):
    pieces = np.ascontiguousarray(words).view(np.uint8)
    b, S, cap = pieces.shape
    lens = np.ascontiguousarray(lens, np.int32)
    out = np.full((b, out_cap), 0xEE, np.uint8)  # every byte must be written
    stats = np.zeros(5, np.int64)
    lib.concat_host(pieces.ctypes.data, lens.ctypes.data, out.ctypes.data, b, S, cap, out_cap, stats.ctypes.data)
    return out, {"reads": int(stats[0]), "bad_reads": int(stats[1]), "windows": int(stats[2]),
                 "not_once": int(stats[3]), "staged_tiles": int(stats[4])}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_header_windows_equal_plain_and_jax(lib, shape, kind):
    words, lens, out_cap = _inputs(shape, kind)
    cap = 4 * words.shape[2]
    assert _in_contract(lens, cap, out_cap) == (kind != "broken")
    assert kind != "one_gaps" or ((lens == 0).any() and (lens == 2).any())
    out, stats = _run(lib, words, lens, out_cap)
    assert stats["bad_reads"] == 0 and stats["not_once"] == 0
    assert stats["windows"] == B * out_cap // 16
    assert (stats["reads"] == 0) == (kind == "zero")
    assert stats["staged_tiles"] == _staged_tiles(lens, cap, out_cap, lib.concat_tile())
    if kind in ("zero", "full", "one", "one_gaps"):  # short sections: the first tile of each row
        assert stats["staged_tiles"] == (0 if kind in ("zero", "full") else B)
    plain = concat.concat_rows_ref(torch.from_numpy(words).view(torch.uint8), torch.from_numpy(lens), out_cap)
    np.testing.assert_array_equal(out, plain.numpy())
    if kind != "broken":
        np.testing.assert_array_equal(out, np.asarray(jax_concat(words, lens, out_cap)))


def test_tile_is_whole_windows_of_its_threads(lib):
    """The harness walks the grid by the header's constants; the tile is
    what chip_smoke.py and the docs assume (2 KiB, one window a thread)."""
    assert lib.concat_tile() == 2048 == 16 * 128


@pytest.mark.parametrize("s, k, window, bad", [
    (0, 0, (0, 16), 0), (0, 93, (1480, 1496), 0),  # words that start below the section's 1500 bytes
    (0, 94, (1488, 1500), 1),      # starts at 1504: past its length, inside its cap
    (0, 96, (0, 16), 1), (0, -1, (0, 16), 1),  # past its cap bytes, before them
    (-1, 0, (0, 16), 1), (1, 0, (1488, 1500), 1),  # no section; an empty section
    (0, 40, (624, 640), 1), (0, 38, (624, 640), 1),  # holds no byte of the window: after, before it
    (0, 39, (632, 648), 0), (0, 0, (16, 16), 1),  # the window's second word; a window past the total
])
def test_checked_load_flags_every_bad_read(lib, s, k, window, bad):
    """The checker the windows run under: section 0 holds 1500 of its 1536
    bytes, section 1 none; each read is flagged exactly when it is bad."""
    assert lib.checked_read(1536, 1500, s, k, *window) == bad
