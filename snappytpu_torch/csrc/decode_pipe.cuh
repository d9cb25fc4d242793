// K2's walk: a Snappy block decoded by a parse -> move pipeline.  Its
// pieces also make K4 (decode_stream.cu: the sizer and the judge, with a
// chunk's ctx_len, write records that move_records moves in a later launch)
// and K5 (decode_tape.cu: a tape producer hands the mover its records).
//
// The Hopper form of the TPU kernel's D-deep software pipeline
// (snappytpu/kernels/decode_vm4.py `_block_loop_pipelined`, which parses op
// i while it moves op i - D).  Three warps of one thread block share the
// work (decode_block.cu wires them together):
//
//   * the sizer warp walks the op headers 32 comp bytes (a window) at a
//     time.  Each lane sizes the op that would start at its byte (op_rules
//     of decode_block.cuh, on the header read from two aligned words by a
//     funnel shift); pointer jumping (__reduce_or_sync, __shfl_sync) from
//     lane 0 marks the real op starts and where the chain leaves the
//     window, which is where the next window starts.  Nothing here needs
//     the output cursor, so the sizer runs ahead.
//   * the judge warp takes the windows in order: a warp scan of the starts'
//     lengths gives each op its output cursor opc, so the rules that
//     depend on opc stay exact; a ballot finds the first op that ends the
//     loop (opc >= out_len or ip >= comp_len) or is bad.  The ops before it
//     become records in a batch of up to 32, handed to the mover whole.
//   * the mover warp takes a batch, one record per lane, and cuts it into
//     groups that read nothing the group writes: a record starts a new
//     group when its source ends past the group's first output byte.
//     Within a group the order of the moves does not matter, so each lane
//     moves its own short record byte by byte and the warp moves the long
//     ones together, and one __syncwarp closes the group.  Sources before
//     the group are final, so the byte-forward semantics of overlapping
//     copies hold: a copy with dist < len reads its period, which lies
//     before it, as from[j % dist].  A dist-1/2/4 fill depends on the
//     record before it; consecutive copies at one distance are joined into
//     one record first, so a run of fills moves as one long copy.
//
// The accept set is decode_block.cuh's, and ok = the loop ended (not on a
// bad op) with ip == comp_len and opc == out_len.  The walk reads up to
// kSlack bytes past comp_len (a window may look past the row's end); those
// bytes never change a flag or an ok row, since a header that reaches them
// is bad by ip + hdr > comp_len and a literal that reaches them by
// ip + hdr + len > comp_len.
//
// Each warp is written once, over a warp policy W: DeviceWarp (one lane
// per thread, __shfl_sync / __ballot_sync) in decode_block.cu, or a host
// policy that runs the 32 lanes one after another (the g++ tests).  W gives
//   W::Var<T>            a value per lane (x[l] is lane l's)
//   each(f)              f(l) for each lane l (on the device: the own lane)
//   shfl(x, src)         lane src's value of x, to every lane
//   gather(x, i)         lane l gets lane i[l]'s value of x
//   reduce_or(x)         the OR of x over the lanes, to every lane
//   ballot(p)            the bit mask of the lanes whose p is true
//   excl_scan(x)         x[l] <- the sum of x over the lanes below l
//   sync()               the moves of the lanes so far are visible to all
// The sizer hands windows to an Out: push(w, ip, window, last) and
// stopped(w); the judge takes them from an In: take(w, ip, starts, head,
// len), release(w), finish(w); and hands records to a Sink: room(n) -> a
// slot pointer with room for n more records, commit(n), finish().  On the
// device these are decode_ring.cuh's rings.

#pragma once

#include <stdint.h>
#include <string.h>

#include "decode_block.cuh"

#ifdef __CUDACC__
#define SNAPPY_UNROLL _Pragma("unroll")
#else
#define SNAPPY_UNROLL
#endif

namespace snappy_pipe {

using snappy_block::kBlockSize;
using snappy_block::kPadOut;
using Op = snappy_block::OpT<int32_t>;

constexpr int kLanes = 32;
constexpr int kSlack = 64;     // readable bytes past comp_len in the staged row
constexpr int kBatch = 32;     // records per batch handed to the mover
constexpr int kShort = 16;     // the longest record a lane moves alone
constexpr int kWordMove = 128;  // the shortest record the warp moves a word per lane
constexpr int32_t kLenCap = kBlockSize + 1;  // lengths above this end the loop

SNAPPY_HD int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

SNAPPY_HD int lowest(uint32_t x) {  // the index of the lowest set bit of x != 0
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

SNAPPY_HD int highest(uint32_t x) {  // the index of the highest set bit of x != 0
#ifdef __CUDA_ARCH__
  return 31 - __clz(x);
#else
  return 31 - __builtin_clz(x);
#endif
}

// One move: out[dst + j] = from[j % period] for j < len, where from is
// comp + src for a literal (dist 0) and out + src = out + dst - dist for a
// copy.
struct Rec {
  int32_t dst;
  int32_t src;
  int32_t len;
  int32_t dist;
};

// The op header at comp byte p: its first four bytes (w, tag lowest) and
// its fifth (b4), from the two aligned words that hold them.
SNAPPY_HD void header_at(const uint8_t* row, int32_t p, uint32_t& w, uint32_t& b4) {
  const int32_t i = p >> 2;
  const uint32_t s = static_cast<uint32_t>(p & 3) * 8;
#ifdef __CUDA_ARCH__
  const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
  const uint32_t a = words[i], b = words[i + 1];
  w = __funnelshift_r(a, b, s);
#else
  uint32_t a, b;
  memcpy(&a, row + 4 * i, 4);
  memcpy(&b, row + 4 * i + 4, 4);
  w = s ? (a >> s) | (b << (32 - s)) : a;
#endif
  b4 = (b >> s) & 0xFFu;
}

// The header bytes of a lane's op and the rules on them: sizes with the
// cursor unknown (opc = 0), the whole rule once it is known.
struct Head {
  uint32_t w;   // the first four header bytes, the tag lowest
  uint32_t b4;  // the fifth
  SNAPPY_HD bool lit() const { return (w & 3u) == 0; }
  SNAPPY_HD Op rules(int32_t ip, int32_t opc, int32_t comp_len, int32_t out_len, int32_t ctx_len) const {
    return snappy_block::op_rules<int32_t>(w & 0xFFu, (w >> 8) & 0xFFu, (w >> 16) & 0xFFu, w >> 24, b4, ip, opc,
                                           comp_len, out_len, ctx_len);
  }
};

// What a window's lanes say before the output cursor is known: each
// lane's op, and which lanes start ops and where the chain leaves.
template <class W>
struct Window {
  typename W::template Var<Head> head;
  typename W::template Var<Op> op;        // sizes (its bad flag is not used)
  typename W::template Var<int32_t> adv;  // comp bytes from the lane's op to the next
  uint32_t starts;                        // the lanes that start an op
  int32_t exit;                           // the next op past the window, from its lane 0
};

// Size the window at comp byte ip: every lane reads the op that would start
// at its byte, then pointer jumping finds the chain from lane 0.  After
// round r the starts hold the chain's first 2^(r+1) ops and jump is each
// lane's successor 2^(r+1) ops on; a window holds at most 16 ops (an op
// takes two bytes or more), so four rounds reach them all.  (Fewer would
// still be right, only slower: the next window starts after the last op
// found.)
template <class W>
SNAPPY_HD void size_window(W& w, const uint8_t* row, int32_t ip, int32_t comp_len, Window<W>& win) {
  using VI = typename W::template Var<int32_t>;
  VI jump, bit;
  w.each([&](int l) {
    Head& h = win.head[l];
    header_at(row, ip + l, h.w, h.b4);
    win.op[l] = h.rules(ip + l, 0, comp_len, kBlockSize, 0);
    win.adv[l] = h.lit() ? win.op[l].hdr + win.op[l].len : win.op[l].hdr;  // >= 2
    jump[l] = win.adv[l] < kLanes - l ? l + win.adv[l] : kLanes;
  });
  uint32_t starts = 1;
  SNAPPY_UNROLL
  for (int r = 0; r < 4; ++r) {
    w.each([&](int l) { bit[l] = (starts >> l & 1u) && jump[l] < kLanes ? static_cast<int32_t>(1u << jump[l]) : 0; });
    starts |= static_cast<uint32_t>(w.reduce_or(bit));
    w.each([&](int l) { bit[l] = jump[l] < kLanes ? jump[l] : 0; });
    const VI twice = w.gather(jump, bit);
    w.each([&](int l) { jump[l] = jump[l] < kLanes ? twice[l] : kLanes; });
  }
  win.starts = starts;
  const int last = highest(starts);
  win.exit = last + w.shfl(win.adv, last);
}

// The sizer: window after window from comp byte 0, each handed to out
// with where it starts.  A window at or past comp_len is the last (its lane
// 0 ends the loop); out.stopped(w) says the judge has ended the block
// earlier, and the next window is then marked last too.  row holds the comp
// bytes with kSlack readable bytes past comp_len; 0 <= comp_len <= 73728.
template <class W, class Out>
SNAPPY_HD void size_block(W& w, const uint8_t* row, int32_t comp_len, Out& out) {
  for (int32_t ip = 0;;) {
    Window<W> win;
    size_window(w, row, ip, comp_len, win);
    const bool last = ip >= comp_len || out.stopped(w);
    out.push(w, ip, win, last);
    if (last) return;
    // past comp_len only if the window holds a bad op, which ends the block
    ip = win.exit < comp_len - ip ? ip + win.exit : comp_len;
  }
}

// The judge: takes the sized windows in order, gives each start its output
// cursor opc by a warp scan of the lengths, finds the first op that ends the
// loop (opc >= out_len or ip >= comp_len) or is bad, and hands the ops
// before it to sink as records.  0 <= out_len <= 65536; a copy may reach
// 0 <= ctx_len <= 65536 bytes before the block's output (0 for K2, a chunk's
// context for K4), and its record's src is then negative.  Returns the ok
// flag; then tells in that it is done (in.finish(w)).
template <class W, class In, class Sink>
SNAPPY_HD bool judge_block(W& w, int32_t comp_len, int32_t out_len, int32_t ctx_len, In& in, Sink& sink) {
  using VI = typename W::template Var<int32_t>;
  using VB = typename W::template Var<bool>;
  typename W::template Var<Head> head;
  VI len, before, hdr, dist;
  VB stop;
  for (int32_t opc = 0;;) {
    int32_t ip;
    uint32_t starts;
    in.take(w, ip, starts, head, len);
    // a length is capped so that no sum overflows (a longer op is bad, and
    // the lanes after the first stop do not count)
    w.each([&](int l) { before[l] = (starts >> l & 1u) ? (len[l] < kLenCap ? len[l] : kLenCap) : 0; });
    len = before;
    w.excl_scan(before);
    w.each([&](int l) {
      const int32_t at = opc + before[l];
      const Op o = head[l].rules(ip + l, at, comp_len, out_len, ctx_len);
      hdr[l] = o.hdr;
      dist[l] = o.dist;
      stop[l] = (starts >> l & 1u) && (at >= out_len || ip + l >= comp_len || o.bad);
    });
    in.release(w);
    const uint32_t stops = w.ballot(stop);
    const uint32_t run = stops ? starts & ((stops & (0u - stops)) - 1u) : starts;  // the starts that execute
    const int n = popc(run);
    if (n) {
      Rec* slot = sink.room(n);
      w.each([&](int l) {
        if (run >> l & 1u) {
          const int32_t at = opc + before[l];
          slot[popc(run & ((1u << l) - 1u))] =
              head[l].lit() ? Rec{at, ip + l + hdr[l], len[l], 0} : Rec{at, at - dist[l], len[l], dist[l]};
        }
      });
      sink.commit(n);
    }
    if (stops) {
      const int k = lowest(stops);
      const int32_t at = opc + w.shfl(before, k);
      sink.finish();
      in.finish(w);
      // ok: the loop ended at op k exactly at the row's and the block's end
      // (an op there would halt the loop, so a bad one does not count)
      return ip + k == comp_len && at == out_len;
    }
    const int last = highest(starts);
    opc += w.shfl(before, last) + w.shfl(len, last);
  }
}

// A lane moves one record byte by byte, four loads before four stores so
// that one wait on shared memory covers four bytes.  A byte's source is
// from[j % period], which never lies in the record's own output.
SNAPPY_HD void move_own(const Rec& r, const uint8_t* comp, uint8_t* out) {
  const uint8_t* from = r.dist ? out + r.src : comp + r.src;
  const int32_t period = r.dist ? r.dist : r.len;
  uint8_t* to = out + r.dst;
  for (int32_t j = 0, k = 0; j < r.len; j += 4) {
    uint8_t v[4];
SNAPPY_UNROLL
    for (int u = 0; u < 4; ++u) {
      v[u] = j + u < r.len ? from[k] : 0;
      k = k + 1 == period ? 0 : k + 1;
    }
SNAPPY_UNROLL
    for (int u = 0; u < 4; ++u)
      if (j + u < r.len) to[j + u] = v[u];
  }
}

SNAPPY_HD uint32_t load_word(const uint8_t* p) {  // p 4-byte aligned
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint32_t*>(p);
#else
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
#endif
}

SNAPPY_HD void store_word(uint8_t* p, uint32_t v) {  // p 4-byte aligned
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint32_t*>(p) = v;
#else
  memcpy(p, &v, 4);
#endif
}

// Lane l's part of a record the warp moves together.  A literal, or a copy
// whose source ends before its output, of kWordMove bytes or more moves a
// word per lane: the output's
// aligned words whole (their four source bytes from two aligned words by a
// funnel shift), the bytes before the first and after the last one by one.
// The words read may reach past the source, never into a byte used.  A
// shorter record moves byte j = l, l + 32, ..., a copy with dist < len from
// its period.
SNAPPY_HD void move_lane(const Rec& r, int l, const uint8_t* comp, uint8_t* out) {
  uint8_t* to = out + r.dst;
  if (r.len >= kWordMove && (!r.dist || r.dist >= r.len)) {
    const uint8_t* from = r.dist ? out + r.src : comp + r.src;
    const int32_t head = (4 - (r.dst & 3)) & 3;  // bytes before the first aligned word
    const int32_t nwords = r.len > head ? (r.len - head) >> 2 : 0;
    const int32_t tail = head + 4 * nwords;      // the bytes from here on are one by one
    if (l < head && l < r.len) to[l] = from[l];
    if (tail + l < r.len) to[tail + l] = from[tail + l];
    // comp and out are word aligned, so from + head is (src + head) & 3 past a
    // word (an offset, not a cast pointer, keeps the loads in shared memory)
    const int32_t mis = (r.src + head) & 3;
    const uint8_t* aligned = from + head - mis;
    const uint32_t shift = static_cast<uint32_t>(mis) * 8;
    for (int32_t i = l; i < nwords; i += kLanes) {
      const uint32_t lo = load_word(aligned + 4 * i), hi = load_word(aligned + 4 * i + 4);
#ifdef __CUDA_ARCH__
      const uint32_t v = __funnelshift_r(lo, hi, shift);
#else
      const uint32_t v = shift ? (lo >> shift) | (hi << (32 - shift)) : lo;
#endif
      store_word(to + head + 4 * i, v);
    }
  } else if (!r.dist) {
    for (int32_t j = l; j < r.len; j += kLanes) to[j] = comp[r.src + j];
  } else if (r.dist >= r.len) {
    for (int32_t j = l; j < r.len; j += kLanes) to[j] = out[r.src + j];
  } else {  // the period out[src .. src + dist): (l + 32 i) % dist, one step at a time
    const int32_t step = kLanes % r.dist;
    int32_t k = l % r.dist;
    for (int32_t j = l; j < r.len; j += kLanes) {
      to[j] = out[r.src + k];
      k += step;
      if (k >= r.dist) k -= r.dist;
    }
  }
}

// Move a batch of n records (lane l holds record l; lanes >= n hold
// nothing), group by group.  First a copy right after a copy at the same
// distance joins it (the TPU kernel's same-distance chain coalescing): both
// set out[x] = out[x - dist], byte-forward, so together they are one copy.
// A run of dist-1/2/4 fills becomes one long record.
template <class W>
SNAPPY_HD void move_batch(W& w, typename W::template Var<Rec>& rec, int n, const uint8_t* comp, uint8_t* out) {
  using VI = typename W::template Var<int32_t>;
  using VB = typename W::template Var<bool>;
  VI dst, src, len, dist, prev, src_end;
  VB head;
  w.each([&](int l) {
    const Rec& r = rec[l];
    dst[l] = r.dst;
    src[l] = r.src;
    len[l] = r.len;
    dist[l] = r.dist;
    prev[l] = l > 0 ? l - 1 : 0;
  });
  const VI prev_dist = w.gather(dist, prev);
  w.each([&](int l) { head[l] = l < n && !(l > 0 && dist[l] != 0 && prev_dist[l] == dist[l]); });
  const uint32_t heads = w.ballot(head);
  const int32_t end = n ? w.shfl(dst, n - 1) + w.shfl(len, n - 1) : 0;
  VI next;  // the next head after lane l (l itself if none)
  w.each([&](int l) {
    const uint32_t later = heads & ~((2u << l) - 1u);
    next[l] = later ? lowest(later) : l;
  });
  const VI next_dst = w.gather(dst, next);
  w.each([&](int l) {
    const uint32_t later = heads & ~((2u << l) - 1u);
    len[l] = head[l] ? (later ? next_dst[l] : end) - dst[l] : 0;
    // the end of the output bytes the record reads (a literal reads none)
    src_end[l] = head[l] && dist[l] ? src[l] + (dist[l] < len[l] ? dist[l] : len[l]) : -1;
  });
  for (int g = 0; g < n;) {
    const int32_t first = w.shfl(dst, g);
    VB reads_group, long_rec;
    w.each([&](int l) { reads_group[l] = l > g && l < n && src_end[l] > first; });
    const uint32_t hits = w.ballot(reads_group);
    const int e = hits ? lowest(hits) : n;  // the group is records [g, e)
    w.each([&](int l) {
      const bool mine = l >= g && l < e && len[l] > 0;
      long_rec[l] = mine && len[l] > kShort;
      if (mine && len[l] <= kShort) move_own(Rec{dst[l], src[l], len[l], dist[l]}, comp, out);
    });
    for (uint32_t todo = w.ballot(long_rec); todo; todo &= todo - 1) {
      const int r = lowest(todo);
      const Rec lr{w.shfl(dst, r), w.shfl(src, r), w.shfl(len, r), w.shfl(dist, r)};
      w.each([&](int l) { move_lane(lr, l, comp, out); });
    }
    w.sync();
    g = e;
  }
}

SNAPPY_HD Rec load_rec(const Rec* p) {  // p 16-byte aligned, read-only while loaded
#ifdef __CUDA_ARCH__
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  return Rec{v.x, v.y, v.z, v.w};
#else
  return *p;
#endif
}

// K4's move phase for one chunk: its n records, in order in memory, moved a
// batch of 32 at a time; each lane loads its record of the next batch before
// the current batch moves, so the loads are in flight while it does.
template <class W>
SNAPPY_HD void move_records(W& w, const Rec* recs, int32_t n, const uint8_t* comp, uint8_t* out) {
  typename W::template Var<Rec> cur, next;
  w.each([&](int l) { cur[l] = l < n ? load_rec(recs + l) : Rec{0, 0, 0, 0}; });
  for (int32_t r0 = 0; r0 < n; r0 += kBatch) {
    const int32_t r1 = r0 + kBatch;
    w.each([&](int l) { next[l] = r1 + l < n ? load_rec(recs + r1 + l) : Rec{0, 0, 0, 0}; });
    move_batch(w, cur, n - r0 < kBatch ? n - r0 : kBatch, comp, out);
    cur = next;
  }
}

}  // namespace snappy_pipe
