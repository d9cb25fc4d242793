// K7's body: tier B of the match finder for one 64 KiB block.  Shared by the
// CUDA kernel (tier_b.cu) and any host build of the same source: under nvcc
// every function is __host__ __device__, under a host compiler plain inline
// C++, so the g++ tests run the kernel's steps without a GPU.
//
// What it computes is kernels/encode_v2.py `_tier_b`'s torch chain, byte for
// byte.  A position p's key is its 16 big-endian 32-bit words, word j the
// bytes p + 4j .. p + 4j + 3, bytes past the block reading 0 and bytes
// between n and the block's end its own; word 0 reads 0xFFFFFFFF for
// p > n - 4, so those tail positions sort last (`_match_words`' w0p).  The
// positions taken (every one, stride 1, for `dense`; every 4th, stride 4, for
// `fast`) are put in order by the sort-key words key_ids, unsigned, in turn,
// with ties in position order (`_lex_order`, a stable sort).  Each sorted
// slot then looks at the slots r before and r after it for each rank r of
// rank_mask: a candidate counts if it lies before the slot's position and
// shares 4 bytes or more of the 16 words with it (the common prefix, capped
// at 64 bytes); the longest wins, on a tie the larger candidate
// (`_tier_best`).  The match is clipped to the bytes left before n, and a
// match under 4 bytes is none (`_sort_back`).
//
// The steps (the kernel runs each over its block's threads, a barrier
// between them): the block's bytes are staged as big-endian words with
// kTailBytes of zeros after them, so that a key's word is two aligned loads
// and a funnel shift, one load where it follows the word read before
// (KeyCursor), and the key itself is never stored.  The
// sub-positions 0 .. N - 1 (N = 65536 / stride) are sorted by a merge sort
// over the comparator key_less, which reads the key words from the staged
// bytes and stops at the first that differs, then falls to position: so the
// order is total and a merge needs no stability of its own.  Level R merges
// runs of R into runs of 2R; each thread writes kThreads-th of the level's
// output, finding where its share starts in its pair of runs by a binary
// search of the merge path, then merging serially with each run's head and
// its first key word held in registers (merge_range).  Each sorted slot's
// match is then slot_match's.  Where the order's entries lie, in shared
// memory and in a level's scratch row, is order_index's and
// scratch_index's: both keep a warp's lanes off each other's banks and
// sectors.

#pragma once

#include <stdint.h>

#ifndef SNAPPY_HD
#ifdef __CUDACC__
#define SNAPPY_HD __host__ __device__ __forceinline__
#else
#define SNAPPY_HD inline
#endif
#endif

namespace snappy_tier_b {

constexpr int32_t kBlock = 65536;                           // bytes a block
constexpr int32_t kKeyWords = 16;                           // words a key: 64 bytes, the LCP's cap
constexpr int32_t kTailBytes = 64;                          // zeros staged after the block: a key reaches byte 65598
constexpr int32_t kTextWords = (kBlock + kTailBytes) / 4;   // the staged text, in words
constexpr int32_t kMinMatch = 4;
constexpr int32_t kMaxRank = 4;                             // neighbour ranks 1 .. 4
constexpr int32_t kThreads = 1024;                          // threads a block; N / kThreads outputs each a level

// What a call fixes: the profile's stride, its sort-key words and its ranks.
struct Params {
  int32_t stride;               // 1 (every position) or 4 (every 4th)
  int32_t nkeys;                // sort-key words, 1 .. 16
  int32_t rank_mask;            // bit r - 1 set: rank r examined, before and after
  uint8_t key_ids[kKeyWords];   // the sort-key words in order, each 0 .. 15, no two alike
};

// The bytes of a little-endian word in big-endian order.
SNAPPY_HD uint32_t be32(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
}

// The big-endian word whose bytes start sh / 8 bytes into staged word cur
// and run on into next.
SNAPPY_HD uint32_t join(uint32_t cur, uint32_t next, int32_t sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(next, cur, sh);
#else
  return static_cast<uint32_t>(((static_cast<uint64_t>(cur) << 32 | next) << sh) >> 32);
#endif
}

// The key at byte position p of a block of n bytes, its words read in
// turn: word j is staged words p / 4 + j and p / 4 + j + 1 joined, so a
// word that follows the one read before it needs one load, not two.  Word
// 0 reads 0xFFFFFFFF for p > n - 4.
struct KeyCursor {
  const uint32_t* t;  // the staged word that holds byte p
  int32_t sh;         // 8 * (p % 4)
  bool tail;          // p > n - 4
  int32_t last;       // the word read last (-2: none yet)
  uint32_t next;      // staged word t[last + 1]

  SNAPPY_HD uint32_t operator()(int32_t j) {
    const uint32_t cur = j == last + 1 ? next : t[j];
    next = t[j + 1];
    last = j;
    return j == 0 && tail ? 0xFFFFFFFFu : join(cur, next, sh);
  }
};

SNAPPY_HD KeyCursor key_at(const uint32_t* T, int32_t n, int32_t p) {
  return KeyCursor{T + (p >> 2), 8 * (p & 3), p > n - kMinMatch, -2, 0u};
}

// Whether sub-position qa sorts before qb: the sort-key words from key_ids[from] on, then position.
SNAPPY_HD bool key_less(const uint32_t* T, const Params& P, int32_t n, int32_t qa, int32_t qb, int32_t from) {
  KeyCursor a = key_at(T, n, qa * P.stride), b = key_at(T, n, qb * P.stride);
  for (int32_t t = from; t < P.nkeys; ++t) {
    const int32_t j = P.key_ids[t];
    const uint32_t wa = a(j), wb = b(j);
    if (wa != wb) return wa < wb;
  }
  return qa < qb;
}

// A run's next sub-position and its first sort-key word.
struct Head {
  int32_t q;
  uint32_t w;
};

SNAPPY_HD Head head(const uint32_t* T, const Params& P, int32_t n, int32_t q) {
  KeyCursor c = key_at(T, n, q * P.stride);
  return Head{q, c(P.key_ids[0])};
}

SNAPPY_HD bool head_less(const uint32_t* T, const Params& P, int32_t n, const Head& a, const Head& b) {
  return a.w != b.w ? a.w < b.w : key_less(T, P, n, a.q, b.q, 1);
}

// Thread t's outputs of a merge level: [range_lo, range_lo + N / kThreads).
SNAPPY_HD int32_t range_lo(int32_t N, int32_t t) { return t * (N / kThreads); }

// Where the order's entries live.  A thread's share of a level is the
// share = N / kThreads entries from range_lo on, and its lanes walk theirs
// side by side.  In shared memory each share is padded by two entries, so
// that the lanes' entries fall in distinct banks (order_index).  In the
// scratch row a level writes, the lanes' j-th outputs lie side by side
// (scratch_index), so a warp's stores are 64 contiguous bytes; the copy
// back reads them so too.  shift = log2(share).
SNAPPY_HD int32_t order_index(int32_t k, int32_t shift) { return k + ((k >> shift) << 1); }

SNAPPY_HD int32_t scratch_index(int32_t k, int32_t shift) {
  return (k & ((1 << shift) - 1)) * kThreads + (k >> shift);
}

// The order in shared memory, entry k.
struct Order {
  const uint16_t* base;
  int32_t shift;
  SNAPPY_HD int32_t operator()(int32_t k) const { return base[order_index(k, shift)]; }
};

// Outputs [lo, hi) of the level that merges the sorted runs of R (a power of
// two below N) in src (N sub-positions) pairwise: run a0 = k & ~(2R - 1)
// with run a0 + R.  A pair whose first run ends below its second's start is
// in order already, and is copied: so a block of equal keys (zeros) costs a
// comparison a share, not one a position.  Else, where the share starts
// inside a pair, the merge path's binary search finds how many of its first
// d outputs come from the first run.  dst(k, q) writes output k.
template <class Src, class Dst>
SNAPPY_HD void merge_range(const uint32_t* T, const Params& P, int32_t n, const Src& src, int32_t R,
                           int32_t lo, int32_t hi, Dst& dst) {
  for (int32_t start = lo; start < hi;) {
    const int32_t a0 = start & ~(2 * R - 1), b0 = a0 + R;
    const int32_t end = hi < a0 + 2 * R ? hi : a0 + 2 * R, d = start - a0;
    if (key_less(T, P, n, src(b0 - 1), src(b0), 0)) {
      for (int32_t k = start; k < end; ++k) dst(k, src(k));
      start = end;
      continue;
    }
    int32_t ia = d > R ? d - R : 0, ihi = d < R ? d : R;
    while (ia < ihi) {
      const int32_t mid = (ia + ihi) >> 1;
      if (key_less(T, P, n, src(a0 + mid), src(b0 + d - 1 - mid), 0)) {
        ia = mid + 1;
      } else {
        ihi = mid;
      }
    }
    int32_t ib = d - ia;
    Head a = ia < R ? head(T, P, n, src(a0 + ia)) : Head{0, 0u};
    Head b = ib < R ? head(T, P, n, src(b0 + ib)) : Head{0, 0u};
    for (int32_t k = start; k < end; ++k) {
      const bool take_a = ib >= R || (ia < R && head_less(T, P, n, a, b));
      dst(k, take_a ? a.q : b.q);
      if (take_a) {
        if (++ia < R) a = head(T, P, n, src(a0 + ia));
      } else {
        if (++ib < R) b = head(T, P, n, src(b0 + ib));
      }
    }
    start = end;
  }
}

// The common prefix, in bytes (0 .. 64), of the 16-word keys at byte positions pa and pb.
SNAPPY_HD int32_t key_lcp(const uint32_t* T, int32_t n, int32_t pa, int32_t pb) {
  KeyCursor a = key_at(T, n, pa), b = key_at(T, n, pb);
  for (int32_t j = 0; j < kKeyWords; ++j) {
    const uint32_t x = a(j) ^ b(j);
    if (x != 0u) {
#ifdef __CUDA_ARCH__
      return 4 * j + (__clz(static_cast<int>(x)) >> 3);
#else
      return 4 * j + (__builtin_clz(x) >> 3);
#endif
    }
  }
  return 4 * kKeyWords;
}

// A position's tier-B match: length (0, or 4 .. 64) and distance (0 with no match).
struct Match {
  int32_t len, dist;
};

// Sorted slot i of order (N sub-positions) against its neighbours: the
// predecessors i - r, then the successors i + r, for each rank r of
// rank_mask.  Its position s, and the match at s.
template <class Src>
SNAPPY_HD Match slot_match(const uint32_t* T, const Params& P, int32_t n, const Src& order, int32_t N, int32_t i,
                           int32_t* s_out) {
  const int32_t s = order(i) * P.stride;
  int32_t best_len = 0, best_cand = -1;
  for (int32_t side = -1; side <= 1; side += 2) {
    for (int32_t r = 1; r <= kMaxRank; ++r) {
      const int32_t k = i + side * r;
      if (!((P.rank_mask >> (r - 1)) & 1) || k < 0 || k >= N) continue;
      const int32_t c = order(k) * P.stride;
      if (c >= s) continue;
      const int32_t l = key_lcp(T, n, s, c);
      if (l >= kMinMatch && (l > best_len || (l == best_len && c > best_cand))) {
        best_len = l;
        best_cand = c;
      }
    }
  }
  *s_out = s;
  const int32_t room = n - s > 0 ? n - s : 0, len = best_len < room ? best_len : room;
  return len >= kMinMatch ? Match{len, s - best_cand} : Match{0, 0};
}

}  // namespace snappy_tier_b
