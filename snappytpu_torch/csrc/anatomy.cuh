// The bodies of the profiling probes T2 (dec_anatomy.cu) and T3
// (tape_probe.cu): K2's and K5's mover warp (decode_pipe.cuh move_batch)
// with one cost changed, written once over decode_pipe.cuh's warp policy W
// so that g++ checks here the source nvcc builds (tests/
// test_torch_probe_host.py).  The probes' producers are the decoders' own:
// K2's sizer and judge, K5's produce_tape; only the mover, and for T3's
// full-D3 the producer's record loads, change.
//
// move_batch_as is move_batch with its memory accesses through a policy Mem
// and its records placed by a functor Place:
//   * a batch is planned as move_batch plans it (plan_batch: consecutive
//     copies at one distance joined into one record, unless join is off)
//     and cut into groups that read nothing the group writes (next_cut, on
//     the records' real addresses, whatever Place makes of them);
//   * each record of a group becomes a flat move (Mv): byte j of [0, len)
//     comes from src + (per ? j % per : j) and goes to dst + j, both offsets
//     from one base, the shared memory that holds the row and the image;
//   * a lane moves its own record of up to kShort bytes, four loads before
//     four stores; the warp moves a longer one together, a word per lane
//     from kWordMove bytes on where it does not read itself (move_lane's
//     aligned words and funnel shift), else byte j by lane j % 32; one
//     w.sync() closes the group;
//   * Mem::ld / ldw read a byte / an aligned word, Mem::st / stw store one,
//     given lo, the record's lowest byte that may be written.  A policy
//     with kCover true gets lo past every byte a later record of the batch
//     also writes (cover), so that records placed on one destination write
//     each byte once a batch, the last op's, and a group's lanes never
//     race; batches are taken in order, so the last op that covers a byte
//     writes it last.
// Each byte of a record is read once and stored once (to Mem, which may
// fold it instead), so a fold of the stores is a fold of the bytes read.
//
// A policy with kEnter true takes enter(w, dst) before each group's moves,
// with the flat destination of the group's first record (T3 acc).

#pragma once

#include <stdint.h>

#include "decode_pipe.cuh"
#include "decode_tape.cuh"

namespace snappy_anat {

using snappy_pipe::kLanes;
using snappy_pipe::kShort;
using snappy_pipe::kWordMove;
using snappy_pipe::Rec;

// A flat move: byte j of [0, len) from src + (per ? j % per : j) to dst + j;
// bytes below lo are read but not stored.
struct Mv {
  int32_t dst;
  int32_t src;
  int32_t len;
  int32_t per;
  int32_t lo;
};

// A record's period as move_batch reads it: a copy that reads its own
// output (dist < len) repeats the dist bytes before it.
SNAPPY_HD int32_t period(int32_t len, int32_t dist) { return dist && dist < len ? dist : 0; }

// A batch as move_batch plans it, lane l holding record l: the heads (lanes
// that start a record after the join, l < n), each head's joined length
// (0 on other lanes) and the end of the output bytes it reads (-1 for a
// literal or a lane that is no head).
template <class W>
struct Plan {
  typename W::template Var<int32_t> dst, src, len, dist, src_end;
  uint32_t heads;
  int n;
};

template <class W>
SNAPPY_HD void plan_batch(W& w, const typename W::template Var<Rec>& rec, int n, bool join, Plan<W>& p) {
  using VI = typename W::template Var<int32_t>;
  using VB = typename W::template Var<bool>;
  VI prev, next;
  VB head;
  w.each([&](int l) {
    p.dst[l] = rec[l].dst;
    p.src[l] = rec[l].src;
    p.len[l] = rec[l].len;
    p.dist[l] = rec[l].dist;
    prev[l] = l > 0 ? l - 1 : 0;
  });
  const VI prev_dist = w.gather(p.dist, prev);
  w.each([&](int l) { head[l] = l < n && !(join && l > 0 && p.dist[l] != 0 && prev_dist[l] == p.dist[l]); });
  p.heads = w.ballot(head);
  p.n = n;
  const int32_t end = n ? w.shfl(p.dst, n - 1) + w.shfl(p.len, n - 1) : 0;
  w.each([&](int l) {
    const uint32_t later = p.heads & ~((2u << l) - 1u);
    next[l] = later ? snappy_pipe::lowest(later) : l;
  });
  const VI next_dst = w.gather(p.dst, next);
  w.each([&](int l) {
    const uint32_t later = p.heads & ~((2u << l) - 1u);
    if (join) p.len[l] = head[l] ? (later ? next_dst[l] : end) - p.dst[l] : 0;
    else if (!head[l]) p.len[l] = 0;
    p.src_end[l] = head[l] && p.dist[l] ? p.src[l] + (p.dist[l] < p.len[l] ? p.dist[l] : p.len[l]) : -1;
  });
}

// move_batch's cut: the group from record g ends before the first later
// record whose source ends past the group's first output byte.
template <class W>
SNAPPY_HD int next_cut(W& w, const Plan<W>& p, int g) {
  typename W::template Var<bool> reads_group;
  const int32_t first = w.shfl(p.dst, g);
  w.each([&](int l) { reads_group[l] = l > g && l < p.n && p.src_end[l] > first; });
  const uint32_t hits = w.ballot(reads_group);
  return hits ? snappy_pipe::lowest(hits) : p.n;
}

// cover[l] = the longest record of the batch after l, 0 for the last.
template <class W>
SNAPPY_HD typename W::template Var<int32_t> cover_of(W& w, const Plan<W>& p) {
  using VI = typename W::template Var<int32_t>;
  VI t, idx;
  w.each([&](int l) { t[l] = l < p.n ? p.len[l] : 0; });
  for (int d = 1; d < kLanes; d <<= 1) {  // suffix max by doubling
    w.each([&](int l) { idx[l] = l + d < kLanes ? l + d : l; });
    const VI y = w.gather(t, idx);
    w.each([&](int l) {
      if (l + d < kLanes && y[l] > t[l]) t[l] = y[l];
    });
  }
  w.each([&](int l) { idx[l] = l + 1 < kLanes ? l + 1 : l; });
  VI c = w.gather(t, idx);
  w.each([&](int l) {
    if (l + 1 >= kLanes) c[l] = 0;
  });
  return c;
}

// A lane's own record, as move_own: four loads before four stores.
template <class Mem>
SNAPPY_HD void own_move(const Mv& m, Mem& mem) {
  const int32_t per = m.per ? m.per : m.len;
  for (int32_t j = 0, k = 0; j < m.len; j += 4) {
    uint8_t v[4];
SNAPPY_UNROLL
    for (int u = 0; u < 4; ++u) {
      v[u] = j + u < m.len ? mem.ld(m.src + k) : 0;
      k = k + 1 == per ? 0 : k + 1;
    }
SNAPPY_UNROLL
    for (int u = 0; u < 4; ++u)
      if (j + u < m.len) mem.st(m.dst + j + u, v[u], m.lo);
  }
}

// Lane l's part of a record the warp moves together, as move_lane.
template <class Mem>
SNAPPY_HD void lane_move(const Mv& m, int l, Mem& mem) {
  if (m.len >= kWordMove && !m.per) {
    const int32_t head = (4 - (m.dst & 3)) & 3;
    const int32_t nwords = m.len > head ? (m.len - head) >> 2 : 0;
    const int32_t tail = head + 4 * nwords;
    if (l < head && l < m.len) mem.st(m.dst + l, mem.ld(m.src + l), m.lo);
    if (tail + l < m.len) mem.st(m.dst + tail + l, mem.ld(m.src + tail + l), m.lo);
    const int32_t mis = (m.src + head) & 3;
    const int32_t aligned = m.src + head - mis;
    const uint32_t shift = static_cast<uint32_t>(mis) * 8;
    for (int32_t i = l; i < nwords; i += kLanes) {
      const uint32_t lo = mem.ldw(aligned + 4 * i), hi = mem.ldw(aligned + 4 * i + 4);
#ifdef __CUDA_ARCH__
      const uint32_t v = __funnelshift_r(lo, hi, shift);
#else
      const uint32_t v = shift ? (lo >> shift) | (hi << (32 - shift)) : lo;
#endif
      mem.stw(m.dst + head + 4 * i, v, m.lo);
    }
  } else if (!m.per) {
    for (int32_t j = l; j < m.len; j += kLanes) mem.st(m.dst + j, mem.ld(m.src + j), m.lo);
  } else {
    const int32_t step = kLanes % m.per;
    int32_t k = l % m.per;
    for (int32_t j = l; j < m.len; j += kLanes) {
      mem.st(m.dst + j, mem.ld(m.src + k), m.lo);
      k += step;
      if (k >= m.per) k -= m.per;
    }
  }
}

// move_batch over Mem: the records of lane l < n, placed by place(dst, src,
// len, dist) -> Mv (its lo is set here).
template <class W, class Place, class Mem>
SNAPPY_HD void move_batch_as(W& w, const typename W::template Var<Rec>& rec, int n, bool join, const Place& place,
                             Mem& mem) {
  using VI = typename W::template Var<int32_t>;
  using VB = typename W::template Var<bool>;
  Plan<W> p;
  plan_batch(w, rec, n, join, p);
  VI cover;
  if (Mem::kCover) cover = cover_of(w, p);
  else w.each([&](int l) { cover[l] = 0; });
  for (int g = 0; g < n;) {
    const int e = next_cut(w, p, g);
    if (Mem::kEnter) mem.enter(w, place(w.shfl(p.dst, g), w.shfl(p.src, g), w.shfl(p.len, g), w.shfl(p.dist, g)).dst);
    VB long_rec;
    w.each([&](int l) {
      const bool mine = l >= g && l < e && p.len[l] > 0;
      long_rec[l] = mine && p.len[l] > kShort;
      if (mine && p.len[l] <= kShort) {
        Mv m = place(p.dst[l], p.src[l], p.len[l], p.dist[l]);
        m.lo = m.dst + cover[l];
        own_move(m, mem);
      }
    });
    for (uint32_t todo = w.ballot(long_rec); todo; todo &= todo - 1) {
      const int r = snappy_pipe::lowest(todo);
      Mv m = place(w.shfl(p.dst, r), w.shfl(p.src, r), w.shfl(p.len, r), w.shfl(p.dist, r));
      m.lo = m.dst + w.shfl(cover, r);
      w.each([&](int l) { lane_move(m, l, mem); });
    }
    w.sync();
    g = e;
  }
}

// Where a batch's last record ends (end if the batch is empty): the final
// output cursor once the last batch is taken.
template <class W>
SNAPPY_HD int32_t batch_end(W& w, const typename W::template Var<Rec>& rec, int n, int32_t end) {
  typename W::template Var<int32_t> e;
  w.each([&](int l) { e[l] = rec[l].dst + rec[l].len; });
  return n ? w.shfl(e, n - 1) : end;
}

// ---- placements ----

// K2's: a literal reads the staged row at comp, a copy the image at out.
struct K2Place {
  int32_t comp, out;
  SNAPPY_HD Mv operator()(int32_t dst, int32_t src, int32_t len, int32_t dist) const {
    return Mv{out + dst, (dist ? out : comp) + src, len, period(len, dist), out + dst};
  }
};

// T2 fixed's: every op from compressed byte kFixedSrc on to image byte 0
// on, a copy that reads its own output with its period.
constexpr int32_t kFixedSrc = 64;
struct FixedPlace {
  int32_t comp, out;
  SNAPPY_HD Mv operator()(int32_t, int32_t, int32_t len, int32_t dist) const {
    return Mv{out, comp + kFixedSrc, len, period(len, dist), out};
  }
};

// K5's: one image holds the row and the output, records in its addresses.
struct ImagePlace {
  SNAPPY_HD Mv operator()(int32_t dst, int32_t src, int32_t len, int32_t dist) const {
    return Mv{dst, src, len, period(len, dist), dst};
  }
};

// T3 const-dst's: every record to one scratch area, its source in place.
struct ScratchPlace {
  int32_t scratch;
  SNAPPY_HD Mv operator()(int32_t, int32_t src, int32_t len, int32_t dist) const {
    return Mv{scratch, src, len, period(len, dist), scratch};
  }
};

// ---- memory policies over one base ----

SNAPPY_HD uint32_t lane_word(uint8_t v, int32_t a) { return static_cast<uint32_t>(v) << (8 * (a & 3)); }

// The moves as they are, on one base (T3 rowbatchK).
struct Plain {
  static constexpr bool kCover = false;
  static constexpr bool kEnter = false;
  uint8_t* base;
  SNAPPY_HD uint8_t ld(int32_t a) const { return base[a]; }
  SNAPPY_HD uint32_t ldw(int32_t a) const { return snappy_pipe::load_word(base + a); }
  SNAPPY_HD void st(int32_t a, uint8_t v, int32_t) { base[a] = v; }
  SNAPPY_HD void stw(int32_t a, uint32_t v, int32_t) { snappy_pipe::store_word(base + a, v); }
  template <class W>
  SNAPPY_HD void enter(W&, int32_t) {}
};

// T2 window: every read, nothing stored; each byte folded into the lane's
// word at its destination's byte lane (a & 3), a word as it is.
struct Fold {
  static constexpr bool kCover = false;
  static constexpr bool kEnter = false;
  const uint8_t* base;
  uint32_t acc = 0;
  SNAPPY_HD uint8_t ld(int32_t a) const { return base[a]; }
  SNAPPY_HD uint32_t ldw(int32_t a) const { return snappy_pipe::load_word(base + a); }
  SNAPPY_HD void st(int32_t a, uint8_t v, int32_t) { acc ^= lane_word(v, a); }
  SNAPPY_HD void stw(int32_t, uint32_t v, int32_t) { acc ^= v; }
  template <class W>
  SNAPPY_HD void enter(W&, int32_t) {}
};

// T2 fixed and T3 const-dst: every byte read and folded, stored only from
// lo on (kCover), so that the last op that covers a byte writes it.
struct Covered {
  static constexpr bool kCover = true;
  static constexpr bool kEnter = false;
  uint8_t* base;
  uint32_t acc = 0;
  SNAPPY_HD uint8_t ld(int32_t a) const { return base[a]; }
  SNAPPY_HD uint32_t ldw(int32_t a) const { return snappy_pipe::load_word(base + a); }
  SNAPPY_HD void st(int32_t a, uint8_t v, int32_t lo) {
    acc ^= lane_word(v, a);
    if (a >= lo) base[a] = v;
  }
  SNAPPY_HD void stw(int32_t a, uint32_t v, int32_t lo) {
    acc ^= v;
    if (a >= lo) {
      snappy_pipe::store_word(base + a, v);
    } else {
      for (int k = 0; k < 4; ++k)
        if (a + k >= lo) base[a + k] = static_cast<uint8_t>(v >> (8 * k));
    }
  }
  template <class W>
  SNAPPY_HD void enter(W&, int32_t) {}
};

// T3 acc: image rows w and w + 1 (512 bytes each, rows below nrows) live
// in a 1 KiB window, row r in half r & 1.  Every access to a held row goes
// to the window, every other one to the image.  Before a group the window
// moves to the rows of its first destination: the rows that leave are
// flushed and those that enter filled, 16 bytes a lane, then w.sync().
// A group reads nothing it writes, so a read finds the last write before
// the group wherever that went.
struct Window {
  static constexpr bool kCover = false;
  static constexpr bool kEnter = true;
  uint8_t* base;
  uint8_t* win;
  int32_t nrows;
  int32_t row;
  SNAPPY_HD bool held(int32_t a) const { return (a >> 9) == row || (a >> 9) == row + 1; }
  SNAPPY_HD uint8_t* at(int32_t a) const { return held(a) ? win + (a & 1023) : base + a; }
  SNAPPY_HD uint8_t ld(int32_t a) const { return *at(a); }
  SNAPPY_HD uint32_t ldw(int32_t a) const { return snappy_pipe::load_word(at(a)); }
  SNAPPY_HD void st(int32_t a, uint8_t v, int32_t) { *at(a) = v; }
  SNAPPY_HD void stw(int32_t a, uint32_t v, int32_t) { snappy_pipe::store_word(at(a), v); }
  // lane l's 16 bytes of row r, from the image to the window or back
  SNAPPY_HD void copy16(int32_t r, int l, bool fill) {
    if (r < 0 || r >= nrows) return;
    uint8_t* img = base + 512 * r + 16 * l;
    uint8_t* w = win + 512 * (r & 1) + 16 * l;
    for (int k = 0; k < 16; k += 4) {
      if (fill) snappy_pipe::store_word(w + k, snappy_pipe::load_word(img + k));
      else snappy_pipe::store_word(img + k, snappy_pipe::load_word(w + k));
    }
  }
  template <class W>
  SNAPPY_HD void load(W& w, int32_t r) {  // the first rows, before any move
    row = r;
    w.each([&](int l) {
      copy16(r, l, true);
      copy16(r + 1, l, true);
    });
    w.sync();
  }
  template <class W>
  SNAPPY_HD void enter(W& w, int32_t dst) {
    const int32_t r = dst >> 9;
    if (r == row) return;
    w.each([&](int l) {
      for (int32_t o = row; o <= row + 1; ++o)
        if (o != r && o != r + 1) copy16(o, l, false);
      for (int32_t o = r; o <= r + 1; ++o)
        if (o != row && o != row + 1) copy16(o, l, true);
    });
    row = r;
    w.sync();
  }
  template <class W>
  SNAPPY_HD void flush(W& w) {  // after the last move
    w.each([&](int l) {
      copy16(row, l, false);
      copy16(row + 1, l, false);
    });
    w.sync();
  }
};

// ---- T3 rowbatchK: groups of K records, in-group reads resolved by address ----

// Record m of a group, uniform over the lanes.
struct Step {
  int32_t dst, src, len, per, lane;
  SNAPPY_HD bool writes(int32_t a) const { return a >= dst && a < dst + len; }
  SNAPPY_HD int32_t from(int32_t j) const { return src + (per ? j % per : j); }
};

// The address whose value byte a of lane `lane`'s record reads before the
// group: through the group's records before it (highest first), a byte one
// of them writes is that record's source byte at the same offset.
template <int K>
SNAPPY_HD int32_t resolve(const Step (&s)[K], int cnt, int lane, int32_t a) {
SNAPPY_UNROLL
  for (int m = K - 1; m >= 0; --m)
    if (m < cnt && s[m].lane < lane && s[m].writes(a)) a = s[m].from(a - s[m].dst);
  return a;
}

// K5's records (joined, as move_batch joins them) moved K heads per group
// with one w.sync(), on one image (comp = out = img).  A record may read
// what an earlier record of its group writes: each byte's source is
// resolved through those records to an address no record of the group
// writes, which holds its value as it was before the group.  That is exact
// when no record writes a byte that an earlier record of the group reads
// or writes, which holds for every batch produce_tape hands over: a forward
// batch's destinations follow one another and each record reads only
// before its own, and any other batch holds one record.  A record of up to
// kShort bytes moves on its own lane, a longer one byte j by lane j % 32
// (no words: a word's bytes may resolve to different places); a group
// whose records read nothing another of them writes skips the resolution.
// The long records move last one first: nothing orders a group's moves on
// the card, and on the host that order makes a missing resolution show.
template <int K, class W, class Mem>
SNAPPY_HD void move_batch_rows(W& w, const typename W::template Var<Rec>& rec, int n, Mem& mem) {
  Plan<W> p;
  plan_batch(w, rec, n, true, p);
  for (uint32_t left = p.heads; left;) {
    Step s[K];
    int cnt = 0;
    uint32_t group = 0;  // the group's lanes
SNAPPY_UNROLL
    for (int i = 0; i < K; ++i) {
      if (left) {
        const int r = snappy_pipe::lowest(left);
        left &= left - 1;
        group |= 1u << r;
        const int32_t len = w.shfl(p.len, r);
        s[i] = Step{w.shfl(p.dst, r), w.shfl(p.src, r), len, period(len, w.shfl(p.dist, r)), r};
        cnt = i + 1;
      } else {
        s[i] = Step{0, 0, 0, 0, kLanes};
      }
    }
    bool chained = false;  // a record of the group reads what an earlier one writes
SNAPPY_UNROLL
    for (int b = 1; b < K; ++b)
SNAPPY_UNROLL
      for (int a = 0; a < b; ++a)
        chained |= b < cnt && s[b].src < s[a].dst + s[a].len && s[a].dst < s[b].src + (s[b].per ? s[b].per : s[b].len);
    w.each([&](int l) {  // a short record on its own lane, four loads before four stores
      const int32_t len = p.len[l];
      if (!(group >> l & 1u) || len > kShort) return;
      const int32_t per = period(len, p.dist[l]), dst = p.dst[l], src = p.src[l];
      const int32_t wrap = per ? per : len;
      for (int32_t j = 0, k = 0; j < len; j += 4) {
        uint8_t v[4];
SNAPPY_UNROLL
        for (int u = 0; u < 4; ++u) {
          v[u] = j + u < len ? mem.ld(chained ? resolve(s, cnt, l, src + k) : src + k) : 0;
          k = k + 1 == wrap ? 0 : k + 1;
        }
SNAPPY_UNROLL
        for (int u = 0; u < 4; ++u)
          if (j + u < len) mem.st(dst + j + u, v[u], dst);
      }
    });
SNAPPY_UNROLL
    for (int i = K - 1; i >= 0; --i)  // a long record by the warp, four bytes a lane before their stores
      if (i < cnt && s[i].len > kShort)
        w.each([&](int l) {
          const Step& x = s[i];
          for (int32_t j = l; j < x.len; j += 4 * kLanes) {
            uint8_t v[4];
SNAPPY_UNROLL
            for (int u = 0; u < 4; ++u) {
              const int32_t k = j + u * kLanes;
              v[u] = k < x.len ? mem.ld(chained ? resolve(s, cnt, x.lane, x.from(k)) : x.from(k)) : 0;
            }
SNAPPY_UNROLL
            for (int u = 0; u < 4; ++u)
              if (j + u * kLanes < x.len) mem.st(x.dst + j + u * kLanes, v[u], x.dst);
          }
        });
    w.sync();
  }
}

// ---- T3's producers: K5's with other record loads ----

// A record's two words, one 8-byte load (read-only while the kernel runs).
SNAPPY_HD void load_pair(const int32_t* p, int32_t& w0, int32_t& w1) {
#ifdef __CUDA_ARCH__
  const int2 v = __ldg(reinterpret_cast<const int2*>(p));
  w0 = v.x;
  w1 = v.y;
#else
  w0 = p[0];
  w1 = p[1];
#endif
}

// full-D3's loads for produce_tape: steps of 32 records through a ring of D
// steps in shared memory.  The call for step g (produce_tape asks for step
// s + 1 as it starts step s) issues step g + D - 1 into the slot step g - 1
// left, each lane its own record by cp.async (global to shared, no
// register waits for it), then waits until at most D - 1 steps are in
// flight, which leaves step g complete, and reads its lane's words; so
// while step s is checked and handed over, steps s + 2 .. s + D are on
// their way and s + 1 is loaded (K5's TapeLoad has only s + 1 in flight).
// Each lane copies and reads only its own ring entries, so no sync is
// needed.  On the host a copy is a plain load and nothing waits.  Call
// drain() before the ring's memory is used again or the kernel ends.
template <int D>
struct AheadLoad {
  const int32_t* tape;  // two int32 words a record
  int32_t nrecs;
  int32_t* ring;        // 2 * 32 * D words, 8-byte aligned
  int32_t issued = 0;   // steps issued

  template <class W>
  SNAPPY_HD void issue(W& w, int32_t g) {
    w.each([&](int l) {
      const int32_t i = kLanes * g + l;
      int32_t* to = ring + 2 * ((g % D) * kLanes + l);
      if (i < nrecs) {
#ifdef __CUDA_ARCH__
        const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(to));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(tape + 2 * i) : "memory");
#else
        to[0] = tape[2 * i];
        to[1] = tape[2 * i + 1];
#endif
      }
    });
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
  }
  template <class W>
  SNAPPY_HD void operator()(W& w, int32_t r, typename W::template Var<int32_t>& w0,
                            typename W::template Var<int32_t>& w1) {
    const int32_t g = r / kLanes;
    while (issued < g + D) issue(w, issued++);
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group %0;\n" ::"n"(D - 1) : "memory");
#endif
    w.each([&](int l) {
      const int32_t* from = ring + 2 * ((g % D) * kLanes + l);
      const bool in = kLanes * g + l < nrecs;
      w0[l] = in ? from[0] : 0;
      w1[l] = in ? from[1] : 0;
    });
  }
  SNAPPY_HD void drain() const {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
  }
};

// ---- T3 loads: the tape words beside the batches ----

constexpr int kStash = 256;  // tape records kept, by index mod kStash

// K5's record loads (decode_tape.cu TapeLoad) that also keep each record's
// two words in a ring by record index, so that a mover that takes a batch
// can fold its tape records (probe_ref's fold) without moving them.  The
// producer is at most three batches and two steps of 32 ahead of the
// mover's batch (the record ring's three slots, the step it checks and the
// one it loaded), 160 records, so a ring of 256 holds every record still
// to be taken.
struct StashLoad {
  const int32_t* tape;  // two int32 words a record
  int32_t nrecs;
  int32_t* stash;       // 2 * kStash words
  template <class W>
  SNAPPY_HD void operator()(W& w, int32_t r, typename W::template Var<int32_t>& w0,
                            typename W::template Var<int32_t>& w1) const {
    w.each([&](int l) {
      const int32_t i = r + l;
      w0[l] = w1[l] = 0;
      if (i < nrecs) load_pair(tape + 2 * i, w0[l], w1[l]);
      stash[2 * (i % kStash)] = w0[l];
      stash[2 * (i % kStash) + 1] = w1[l];
    });
  }
};

// The fold of one record (tools/tape_probe.py `_fold`).
SNAPPY_HD uint32_t fold_record(const snappy_tape::Record& r) {
  return static_cast<uint32_t>(r.src) ^ (static_cast<uint32_t>(r.dst) << 4) ^ (static_cast<uint32_t>(r.len) << 20) ^
         (static_cast<uint32_t>(r.period) << 28);
}

// The batch of records taken .. taken + n - 1: lane l folds record taken + l.
SNAPPY_HD uint32_t fold_stashed(const int32_t* stash, int32_t taken, int n, int l) {
  if (l >= n) return 0;
  const int32_t i = (taken + l) % kStash;
  return fold_record(snappy_tape::decode_record(stash[2 * i], stash[2 * i + 1]));
}

}  // namespace snappy_anat
