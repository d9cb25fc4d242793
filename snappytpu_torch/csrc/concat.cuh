// K1's body: the row's section offsets, the sections that start in a tile,
// and one 16-byte window of the row gathered from its sections.  Shared by
// the CUDA kernel (concat.cu) and any host build of the same source: under
// nvcc every function is __host__ __device__, under a host compiler plain
// inline C++, so the g++ tests run the kernel's windows without a GPU.
//
// Row b of the output holds the first lens[b, s] bytes of each of its S
// sections (cap bytes apart), back to back, zero-padded to out_cap.  Each
// length is clamped to [0, cap] and nothing is written at or past out_cap, so
// a row whose lengths break the contract (negative, above cap, summing past
// out_cap) still writes only itself and equals the plain version
// (kernels/concat.py concat_rows_ref).
//
// The contract the wrapper checks: cap % 16 == 0, out_cap % 16 == 0, pieces
// and out 16-byte aligned.  So every section starts on a 16-byte word, and
// the row is a whole number of 16-byte windows, each written by one store.
//
// The output is cut into tiles of kTile bytes, one thread block each, and a
// thread owns one window of its tile (window_start).  Warp 0 of the block
// takes the clamped exclusive scan of the row's lengths (scan_lengths).  Each
// thread finds the section that holds its window's first byte by binary
// search (first_section), loads the words the window needs of it and of
// the next section, which starts inside the window and needs only its word
// 0, and places both (begin_window).  A third or later section of a window
// starts inside it too: where any window of the tile has one, each nonempty
// section that starts inside the tile writes its bytes, up to the end of the
// window it starts in, into a shared-memory stage of the tile
// (tile_sections, stage_sections), and such a window takes its bytes after
// its first section from there (end_window).  A row with no section of 1 to
// 14 bytes has no such window, and its blocks skip the vote on a stage.  So
// each thread waits on one round trip to memory, and one more barrier where
// there is a stage, and spends constant time on its window however many
// sections it holds (up to 16 of one byte).  Each section's words are
// shifted into place by funnel shifts over 32-bit lanes, masked to the
// overlap and ORed in (place).  Bytes that no section covers stay 0: the
// zero tail and the clamp are one rule.
//
// Reads: a word is loaded only where a window's bytes reach into it, so it
// starts below the section's clamped length (<= cap) and, cap being a
// multiple of 16, ends within the section's cap bytes; a window at or past
// the row's total reads nothing, and a section is staged only if it starts
// inside the tile below the total, from the word that holds its first byte.

#pragma once

#include <stdint.h>

#ifndef SNAPPY_HD
#ifdef __CUDACC__
#define SNAPPY_HD __host__ __device__ __forceinline__
#else
#define SNAPPY_HD inline
#endif
#endif

namespace snappy_concat {

constexpr int32_t kThreads = 128;              // threads per block, one window each
constexpr int32_t kWindow = 16;                // bytes per window: one 16-byte store
constexpr int32_t kTile = kThreads * kWindow;  // output bytes per block

// Words of 16 bytes as four little-endian 32-bit lanes.
struct Word {
  uint32_t x[4];
};

// Thread t's window in tile `tile`: consecutive threads own consecutive
// windows, so a warp's stores are 512 contiguous bytes.
SNAPPY_HD int32_t window_start(int32_t tile, int32_t t) { return tile * kTile + t * kWindow; }

SNAPPY_HD int32_t clamp_len(int32_t v, int32_t cap) { return v < 0 ? 0 : (v > cap ? cap : v); }

// off[s] = the sum of the clamped lens[0 .. s) for s = 0 .. S; off[S] is the
// row's total, which passes out_cap when the lengths break the contract.
// off[S + 1] counts the sections of 1 to 14 bytes: only such a section can
// lie inside a window between two others, so a row without one has no
// window of three sections or more.  Run by one warp under a policy W
// (decode_pipe.cuh's idiom): W::Var<T> a value per lane, each(f) f(l) for
// each lane l, excl_scan(x) x[l] <- the sum of x over the lanes below l,
// shfl(x, src) lane src's x to every lane.
template <class W>
SNAPPY_HD void scan_lengths(W& w, const int32_t* lens, int32_t S, int32_t cap, int32_t* off) {
  int32_t carry = 0, shorts = 0;
  for (int32_t base = 0; base < S; base += 32) {
    typename W::template Var<int32_t> len, ex, short_, short_ex;
    w.each([&](int l) {
      len[l] = ex[l] = base + l < S ? clamp_len(lens[base + l], cap) : 0;
      short_[l] = short_ex[l] = len[l] > 0 && len[l] < kWindow - 1;
    });
    w.excl_scan(ex);
    w.excl_scan(short_ex);
    w.each([&](int l) {
      if (base + l < S) off[base + l] = carry + ex[l];
    });
    carry += w.shfl(ex, 31) + w.shfl(len, 31);
    shorts += w.shfl(short_ex, 31) + w.shfl(short_, 31);
  }
  w.each([&](int l) {
    if (l == 0) {
      off[S] = carry;
      off[S + 1] = shorts;
    }
  });
}

// The last section whose first byte is at or before p (off[0] = 0 <= p).
// For p below the row's total it is the section that holds byte p: empty
// sections share the offset of the one after them and are passed over.
SNAPPY_HD int32_t first_section(const int32_t* off, int32_t S, int32_t p) {
  int32_t lo = 0, hi = S - 1;
  while (lo < hi) {
    const int32_t mid = (lo + hi + 1) >> 1;
    if (off[mid] <= p) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The sections that start in tile `tile` below min(row total, out_cap):
// s >= sa with off[s] < end, sa the first section with off[s] at or past the
// tile's first byte t0.
struct TileSections {
  int32_t t0, sa, end;
};

SNAPPY_HD TileSections tile_sections(const int32_t* off, int32_t S, int32_t out_cap, int32_t tile) {
  const int32_t t0 = tile * kTile;
  int32_t lo = 0, hi = S;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (off[mid] < t0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int32_t end = t0 + kTile < off[S] ? t0 + kTile : off[S];
  return TileSections{t0, lo, end < out_cap ? end : out_cap};
}

// (hi:lo) >> sh, the low 32 bits, for sh in [0, 32).
SNAPPY_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, int32_t sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, static_cast<uint32_t>(sh));
#else
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32) | lo) >> sh);
#endif
}

// The bytes of a 32-bit lane below its byte n, as a mask (n outside [0, 4]
// counts as the nearer end).
SNAPPY_HD uint32_t bytes_below(int32_t n) { return n <= 0 ? 0u : (n >= 4 ? ~0u : (1u << (8 * n)) - 1u); }

// Where section s meets window p: window byte j is the section's byte d + j
// (d < 0 if the section starts inside the window), up to its byte end.  The
// section's word k = d >> 4 (16k <= d, k = -1 for d < 0) holds the window's
// first bytes, word k + 1 the rest.
struct Part {
  int32_t d, end, k;
};

SNAPPY_HD Part part_of(const int32_t* off, int32_t s, int32_t p) {
  const int32_t len = off[s + 1] - off[s], d = p - off[s];
  return Part{d, d + kWindow < len ? d + kWindow : len, d >> 4};
}

// ORs into v the window bytes [max(-d, 0), end - d) of words k, k + 1,
// shifted down by d mod 16 bytes by funnel shifts over 32-bit lanes.
SNAPPY_HD void place(const Part& q, const Word& lo, const Word& hi, Word& v) {
  const uint32_t w[8] = {lo.x[0], lo.x[1], lo.x[2], lo.x[3], hi.x[0], hi.x[1], hi.x[2], hi.x[3]};
  const int32_t r = q.d - kWindow * q.k, c = r >> 2, sh = 8 * (r & 3);
  uint32_t y[5];  // lanes c .. c + 4 of the 32 bytes
  for (int i = 0; i < 5; ++i) y[i] = c == 0 ? w[i] : (c == 1 ? w[i + 1] : (c == 2 ? w[i + 2] : w[i + 3]));
  const int32_t jlo = q.d < 0 ? -q.d : 0, jhi = q.end - q.d;
  for (int i = 0; i < 4; ++i) {
    v.x[i] |= funnel_r(y[i], y[i + 1], sh) & bytes_below(jhi - 4 * i) & ~bytes_below(jlo - 4 * i);
  }
}

// A window's bytes from its first two sections, v; more: a third section
// starts inside it, and then the sections that start inside it cover its
// bytes [from, to), which the tile's stage holds.
struct Window {
  Word v;
  int32_t from, to;
  bool more;
};

// Starts window [p, p + 16), p % 16 == 0; load(s, k) gives word k (bytes
// [16k, 16k + 16)) of section s.  A window at or past min(row total,
// out_cap) reads nothing.  The first section holds byte p (d >= 0): the
// window needs its word k, and word k + 1 if the overlap reaches into it.
// The next nonempty section, if it starts inside the window, needs only its
// word 0.  All are loaded before any is used.
template <class Load>
SNAPPY_HD Window begin_window(const Load& load, const int32_t* off, int32_t S, int32_t out_cap, int32_t p) {
  const Word zero{{0u, 0u, 0u, 0u}};
  Window w{zero, 0, 0, false};
  if (p >= off[S] || p >= out_cap) return w;
  const int32_t s0 = first_section(off, S, p);
  const Part q0 = part_of(off, s0, p);
  const Word lo = load(s0, q0.k);
  const Word hi = q0.end > kWindow * (q0.k + 1) ? load(s0, q0.k + 1) : zero;
  const int32_t e = off[s0 + 1];
  const bool two = e < p + kWindow && e < off[S];
  const int32_t s1 = two ? first_section(off, S, e) : s0;
  const Word next = two ? load(s1, 0) : zero;
  place(q0, lo, hi, w.v);
  if (two) {
    place(part_of(off, s1, p), zero, next, w.v);
    w.more = off[s1 + 1] < p + kWindow && off[s1 + 1] < off[S];
    w.from = e - p;
    w.to = off[S] - p < kWindow ? off[S] - p : kWindow;
  }
  return w;
}

// Thread t's share of staging a tile in which a window holds three sections
// or more: each nonempty section ts.sa + t, ts.sa + t + kThreads, ... that
// starts in the tile writes its bytes up to the end of the window it starts
// in, from its word 0, to stage[byte - t0] (kTile bytes).  The sections that
// start inside a window cover its bytes from the first of them on, below
// the row's total, so the stage then holds them all.
template <class Load>
SNAPPY_HD void stage_sections(const Load& load, const int32_t* off, int32_t S, const TileSections& ts, int32_t t,
                              uint8_t* stage) {
  for (int32_t s = ts.sa + t; s < S && off[s] < ts.end; s += kThreads) {
    const int32_t len = off[s + 1] - off[s];
    if (len == 0) continue;
    const Word head = load(s, 0);
    const int32_t n = len < kWindow - (off[s] & (kWindow - 1)) ? len : kWindow - (off[s] & (kWindow - 1));
    for (int j = 0; j < kWindow; ++j) {
      if (j < n) stage[off[s] - ts.t0 + j] = static_cast<uint8_t>(head.x[j >> 2] >> (8 * (j & 3)));
    }
  }
}

// Ends the window: where a third section starts inside it, its bytes from
// the second section on come from the tile's stage (stage4, the stage as
// 32-bit lanes, t0 its first byte); the second section's are there too, the
// same bytes again.
SNAPPY_HD Word end_window(const Window& w, const uint32_t* stage4, int32_t t0, int32_t p) {
  Word v = w.v;
  if (!w.more) return v;
  for (int i = 0; i < 4; ++i) {
    v.x[i] |= stage4[(p - t0) / 4 + i] & bytes_below(w.to - 4 * i) & ~bytes_below(w.from - 4 * i);
  }
  return v;
}

}  // namespace snappy_concat
