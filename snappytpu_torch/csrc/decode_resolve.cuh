// The byte-source resolver: the body of K3's second launch (decode_block.cu)
// and of K6 (decode_tape.cu).  Shared by the CUDA kernels and any host build
// of the same source: under nvcc every function is __host__ __device__,
// under a host compiler plain inline C++, so the g++ tests run a block's
// threads phase by phase without a GPU.
//
// A block's output is written by a list of records (decode_pipe.cuh's Rec,
// or the tape records of decode_tape.cuh), each moving len bytes into
// [dst, dst + len).  Where the records that run write only the output
// region, each byte at most once, in ascending dst order, and each byte's
// source lies before its own record's first byte or at or past its end, the
// final value of output byte j is fixed by a chain of sources:
//   j <- s(j) <- s(s(j)) <- ...
// ending at a byte of the compressed row, at a guard byte (zero), at a byte
// no record writes (zero), or at a byte past the end of the record that
// reads it, which no record had written when that record ran (zero: later
// records write only past it).  The walk of K2, K3's old kernel, K5 and T3
// follows these chains one record at a time; here every byte follows its own
// chain at once, by pointer jumping (the byte-level form of the
// multi-round resolution in "Massively-Parallel Lossless Data
// Decompression", PAPERS.md).
//
// Coordinates are the tape's unified image (decode_tape.cuh): the guard
// [0, 512), the compressed row [512, 74240), the 64 KiB output from
// kOutBase = 74240.  A Span is one record in that form: byte i of
// [dst, dst + len) comes from src + i, or from src + i % period for a fill
// (a tape fill of period 1, 2 or 4, or a Snappy copy with dist < len, which
// byte-forward repeats the dist bytes before it: both read only before dst,
// so the chains stay short).
//
// State in shared memory (kSmemBytes): the 64 KiB output image out[] and a
// uint16 ptr[] over it.  ptr[j] == j means out[j] is final; otherwise
// ptr[j] < j is the output byte whose final value out[j] takes.  Sources
// below kOutBase are never stored as pointers: they are resolved when the
// records are placed.  The block (kThreads threads) runs:
//   1. marks: ptr[] = kNone, then each record with len > 0 writes its index
//      at its first byte;
//   2. a max-scan over the marks, kThreads units of 8 bytes at a time: each
//      byte gets the last record starting at or before it (the records are
//      ascending, so that is the record holding it, if any);
//   3. place: each byte takes its record's source: a row byte is read from
//      global memory, a guard or not-yet-written byte is zero, a byte of the
//      output before the record becomes a pointer.  A unit whose eight
//      bytes all lie in one literal (a record of period 0 reading the row)
//      takes them in one aligned 8-byte load of the row, or two and a
//      shift; any other unit reads its row bytes one by one;
//   4. rounds: for each j with ptr[j] = k != j, if ptr[k] == k then
//      out[j] = out[k] and ptr[j] = j, else ptr[j] = ptr[k].  A thread owns
//      the units t, t + kThreads, ... and runs a round in two batches of
//      kBatch units, each a read half (into registers) and a write half
//      separated by a barrier, so a reader never sees ptr[k] == k before
//      out[k] is written.  The second batch may read what the first wrote
//      in the same round; that only helps: a pointer only moves along its
//      chain, and a resolved byte is final.  After round r every byte whose
//      chain has at most 2^r - 1 hops is resolved, and every chain is
//      shorter than 2^16 (each hop goes down), so 16 rounds suffice.  The
//      loop ends when no thread has a pending unit (__syncthreads_or); a
//      block still unresolved after kMaxRounds reports kMaxRounds + 1 and
//      its caller not ok.
//
// Each phase is written once over a block policy B:
//   B::Var<T>           a value per thread (x[t] is thread t's)
//   each(f)             f(t) for each thread t (on the device: its own)
//   sync()              the block's barrier
//   any(p)              the OR of p over the threads; a barrier
//   min(x)              the minimum of x over the threads; a barrier
//   excl_max_scan(x)    x[t] <- the max of x over the threads below t (-1 for
//                       none); returns the max over all; a barrier
// DeviceBlock below is the device's; the host tests run the threads of each
// phase one after another, forward and in reverse.  A host build may also
// give the Image a Watch, which sees every access to out[] and ptr[]: the
// host tests' policy then counts, between two barriers, every element one
// thread reads or writes and another writes, so a missing barrier fails a
// host test whatever order the threads run in.

#pragma once

#include <stdint.h>
#include <string.h>

#include "decode_block.cuh"
#include "decode_pipe.cuh"
#include "decode_tape.cuh"

#ifdef __CUDA_ARCH__
#define SNAPPY_RESOLVE_ASSERT(x) ((void)0)
#else
#include <assert.h>
#define SNAPPY_RESOLVE_ASSERT(x) assert(x)
#endif

// Tell an Image's Watch (a host build's only) of an access to out[] or ptr[].
#ifdef __CUDACC__
#define SNAPPY_RESOLVE_WATCH(im, access, p, n) ((void)0)
#else
#define SNAPPY_RESOLVE_WATCH(im, access, p, n) ((im).watch ? (im).watch->access((p), (n)) : (void)0)
#endif

namespace snappy_resolve {

using snappy_block::kBlockSize;
using snappy_block::kPadOut;
using snappy_tape::kCompOff;
using snappy_tape::kImageBytes;
using snappy_tape::kOutBase;

constexpr int kThreads = 1024;                      // threads per block
constexpr int kUnit = 8;                            // output bytes per unit: one 16-byte ptr load
constexpr int kUnits = kBlockSize / kUnit;          // 8192
constexpr int kUnitsPerThread = kUnits / kThreads;  // 8, units t + k * kThreads
constexpr int kBatch = 4;                           // units per thread per half round
constexpr int kMaxRounds = 17;                      // 16 suffice; more is a fault
constexpr int kWalked = -1;                         // K6's rounds for a block that ran the walk
constexpr uint32_t kNone = 0xFFFF;                  // no record starts here (step 1)
constexpr size_t kSmemBytes = kBlockSize + 2 * kBlockSize;  // out[] + ptr[]: 196,608
constexpr size_t kSmemLimit = 232448;                       // an H100 block's dynamic shared memory

struct BlockScratch {  // DeviceBlock's static shared memory: one value per warp
  int32_t totals[kThreads / 32];
};

static_assert(kBlockSize - 1 <= 0xFFFF, "output indices fit ptr's 16 bits");
static_assert(kUnitsPerThread % kBatch == 0 && kUnitsPerThread <= 32, "a thread's units fit a 32-bit mask");
static_assert(kSmemBytes + sizeof(BlockScratch) <= kSmemLimit, "image + ptr + scratch fit one block");
static_assert(kImageBytes + sizeof(BlockScratch) <= kSmemLimit, "K6's walk image fits the same block");
static_assert(kOutBase - kCompOff == kPadOut && kPadOut % 8 == 0, "the row's bytes, in 8-byte words");

// One record in image coordinates (see the top of the file).
struct Span {
  int32_t dst;
  int32_t src;
  int32_t len;
  int32_t period;  // 0: byte i from src + i; else from src + i % period
};

// A tape record that in_image accepted: a copy reads src + i, a fill the p
// bytes before dst.
SNAPPY_HD Span tape_span(const snappy_tape::Record& r) {
  const int32_t dst = static_cast<int32_t>(r.dst), len = static_cast<int32_t>(r.len);
  const int32_t p = static_cast<int32_t>(r.period);
  return p ? Span{dst, dst - p, len, p} : Span{dst, static_cast<int32_t>(r.src), len, 0};
}

// A record of K2's judge with ctx_len 0 (K4a): a literal reads the row from
// src, a copy the output from dst - dist.
SNAPPY_HD Span rec_span(const snappy_pipe::Rec& r) {
  if (!r.dist) return Span{static_cast<int32_t>(kOutBase) + r.dst, static_cast<int32_t>(kCompOff) + r.src, r.len, 0};
  return Span{static_cast<int32_t>(kOutBase) + r.dst, static_cast<int32_t>(kOutBase) + r.src, r.len,
              r.dist < r.len ? r.dist : 0};
}

// K3's records: K4a's buffer, one 16-byte load each.
struct RecSpans {
  const snappy_pipe::Rec* recs;
  SNAPPY_HD Span operator()(int32_t r) const { return rec_span(snappy_pipe::load_rec(recs + r)); }
};

// K6's records: Fetch(r) gives tape record r.
template <class Fetch>
struct TapeSpans {
  Fetch fetch;
  SNAPPY_HD Span operator()(int32_t r) const { return tape_span(fetch(r)); }
};

#ifndef __CUDACC__
// A host build's observer of the accesses to out[] and ptr[] (n bytes at p).
struct Watch {
  virtual void read(const void* p, size_t n) = 0;
  virtual void write(const void* p, size_t n) = 0;

 protected:
  ~Watch() = default;
};
#endif

struct Image {
  uint8_t* out;        // kBlockSize bytes, 16-byte aligned
  uint16_t* ptr;       // kBlockSize entries, 16-byte aligned
  const uint8_t* row;  // the block's compressed row, kPadOut bytes, 8-byte aligned (device memory on the card)
#ifndef __CUDACC__
  Watch* watch = nullptr;
#endif
};

// Eight bytes of the image: their pointers, two to a word, and their values.
struct Unit {
  uint32_t p[4];
  uint32_t v[2];
};

SNAPPY_HD uint32_t ptr_of(const Unit& x, int e) { return (x.p[e >> 1] >> ((e & 1) * 16)) & 0xFFFFu; }
SNAPPY_HD void set_ptr(Unit& x, int e, uint32_t p) {
  const int s = (e & 1) * 16;
  x.p[e >> 1] = (x.p[e >> 1] & ~(0xFFFFu << s)) | (p << s);
}
SNAPPY_HD uint32_t val_of(const Unit& x, int e) { return (x.v[e >> 2] >> ((e & 3) * 8)) & 0xFFu; }
SNAPPY_HD void set_val(Unit& x, int e, uint32_t v) {
  const int s = (e & 3) * 8;
  x.v[e >> 2] = (x.v[e >> 2] & ~(0xFFu << s)) | (v << s);
}

SNAPPY_HD void load_unit(const Image& im, int u, Unit& x) {
#ifdef __CUDA_ARCH__
  const uint4 p = reinterpret_cast<const uint4*>(im.ptr)[u];
  const uint2 v = reinterpret_cast<const uint2*>(im.out)[u];
  x.p[0] = p.x;
  x.p[1] = p.y;
  x.p[2] = p.z;
  x.p[3] = p.w;
  x.v[0] = v.x;
  x.v[1] = v.y;
#else
  SNAPPY_RESOLVE_WATCH(im, read, im.ptr + kUnit * u, sizeof x.p);
  SNAPPY_RESOLVE_WATCH(im, read, im.out + kUnit * u, sizeof x.v);
  memcpy(x.p, im.ptr + kUnit * u, sizeof x.p);
  memcpy(x.v, im.out + kUnit * u, sizeof x.v);
#endif
}

SNAPPY_HD void store_unit(const Image& im, int u, const Unit& x) {
#ifdef __CUDA_ARCH__
  reinterpret_cast<uint4*>(im.ptr)[u] = make_uint4(x.p[0], x.p[1], x.p[2], x.p[3]);
  reinterpret_cast<uint2*>(im.out)[u] = make_uint2(x.v[0], x.v[1]);
#else
  SNAPPY_RESOLVE_WATCH(im, write, im.ptr + kUnit * u, sizeof x.p);
  SNAPPY_RESOLVE_WATCH(im, write, im.out + kUnit * u, sizeof x.v);
  memcpy(im.ptr + kUnit * u, x.p, sizeof x.p);
  memcpy(im.out + kUnit * u, x.v, sizeof x.v);
#endif
}

SNAPPY_HD uint32_t ptr_at(const Image& im, uint32_t k) {
  SNAPPY_RESOLVE_WATCH(im, read, im.ptr + k, sizeof *im.ptr);
  return im.ptr[k];
}

SNAPPY_HD uint32_t out_at(const Image& im, uint32_t k) {
  SNAPPY_RESOLVE_WATCH(im, read, im.out + k, 1);
  return im.out[k];
}

SNAPPY_HD uint32_t row_byte(const uint8_t* row, int32_t i) {
#ifdef __CUDA_ARCH__
  return __ldg(row + i);
#else
  return row[i];
#endif
}

// Row bytes [o, o + 8), little-endian: one aligned 8-byte load, or, for an
// o not a multiple of 8, the two words holding them and a shift (o + 8 <=
// kPadOut keeps the second word inside the row).
SNAPPY_HD uint64_t row_word(const uint8_t* row, int32_t o) {
  SNAPPY_RESOLVE_ASSERT(0 <= o && o + 8 <= kPadOut);
  const int32_t a = o & ~7;
  const int sh = (o & 7) * 8;
#ifdef __CUDA_ARCH__
  const unsigned long long* w = reinterpret_cast<const unsigned long long*>(row + a);
  const uint64_t lo = __ldg(w);
  return sh ? (lo >> sh) | (static_cast<uint64_t>(__ldg(w + 1)) << (64 - sh)) : lo;
#else
  uint64_t lo, hi = 0;
  memcpy(&lo, row + a, 8);
  if (sh) memcpy(&hi, row + a + 8, 8);
  return sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
#endif
}

// A thread's batch of a round: kBatch units jumped once, and which changed.
struct Step {
  Unit x[kBatch];
  uint32_t dirty;
};

// Whether some byte of the unit is not final.
SNAPPY_HD bool unit_open(const Unit& x, int u) {
  bool open = false;
  SNAPPY_UNROLL
  for (int e = 0; e < kUnit; ++e) open |= ptr_of(x, e) != static_cast<uint32_t>(kUnit * u + e);
  return open;
}

// Step 2: the largest mark in unit u (-1 for none), and the unit's marks
// replaced by the running maximum from carry.
SNAPPY_HD int32_t unit_max(const Image& im, int u) {
  Unit x;
  load_unit(im, u, x);
  int32_t m = -1;
  SNAPPY_UNROLL
  for (int e = 0; e < kUnit; ++e) {
    const uint32_t r = ptr_of(x, e);
    if (r != kNone && static_cast<int32_t>(r) > m) m = static_cast<int32_t>(r);
  }
  return m;
}

SNAPPY_HD void fill_unit(const Image& im, int u, int32_t carry) {
  Unit x;
  load_unit(im, u, x);
  SNAPPY_UNROLL
  for (int e = 0; e < kUnit; ++e) {
    const uint32_t r = ptr_of(x, e);
    if (r != kNone && static_cast<int32_t>(r) > carry) carry = static_cast<int32_t>(r);
    set_ptr(x, e, carry < 0 ? kNone : static_cast<uint32_t>(carry));
  }
  store_unit(im, u, x);
}

// Step 3 for unit u, whose ptr[] holds each byte's record (kNone for none).
// Returns whether some byte of it is left to the rounds.
template <class Spans>
SNAPPY_HD bool place_unit(const Image& im, int u, const Spans& spans) {
  Unit x;
  load_unit(im, u, x);
  const int32_t j0 = kUnit * u;
  int32_t cur = -1;
  Span sp{0, 0, 0, 0};
  if (ptr_of(x, 0) != kNone) {
    cur = static_cast<int32_t>(ptr_of(x, 0));
    sp = spans(cur);
    const int32_t i = static_cast<int32_t>(kOutBase) + j0 - sp.dst, s = sp.src + i;
    if (ptr_of(x, kUnit - 1) == static_cast<uint32_t>(cur) && !sp.period && i + kUnit <= sp.len && s >= kCompOff &&
        s + kUnit <= kOutBase) {  // all eight bytes from one literal's row bytes
      const uint64_t w = row_word(im.row, s - static_cast<int32_t>(kCompOff));
      SNAPPY_UNROLL
      for (int e = 0; e < kUnit; ++e) set_ptr(x, e, static_cast<uint32_t>(j0 + e));
      x.v[0] = static_cast<uint32_t>(w);
      x.v[1] = static_cast<uint32_t>(w >> 32);
      store_unit(im, u, x);
      return false;
    }
  }
  SNAPPY_UNROLL
  for (int e = 0; e < kUnit; ++e) {
    const int32_t j = j0 + e;
    const uint32_t r = ptr_of(x, e);
    uint32_t p = static_cast<uint32_t>(j), v = 0;
    if (r != kNone) {
      if (static_cast<int32_t>(r) != cur) {
        cur = static_cast<int32_t>(r);
        sp = spans(cur);
      }
      const int32_t i = static_cast<int32_t>(kOutBase) + j - sp.dst;  // >= 0: the span starts at or before j
      SNAPPY_RESOLVE_ASSERT(i >= 0);
      if (i < sp.len) {
        const int32_t s = sp.src + (sp.period ? i % sp.period : i);
        if (s >= kOutBase && s < sp.dst) {  // an output byte before the span: its chain
          p = static_cast<uint32_t>(s - kOutBase);
          SNAPPY_RESOLVE_ASSERT(p < static_cast<uint32_t>(j));
        } else if (s >= kCompOff && s < kOutBase) {  // the compressed row
          v = row_byte(im.row, s - static_cast<int32_t>(kCompOff));
        }
        // else the guard, or a byte at or past the span's end, which no
        // record had written when the span ran: zero (a source inside the
        // span's own bytes is refused by in_image, and K4a's copies and
        // every fill read before dst)
        SNAPPY_RESOLVE_ASSERT(s < sp.dst || s >= sp.dst + sp.len);
      }
    }
    set_ptr(x, e, p);
    set_val(x, e, v);
  }
  store_unit(im, u, x);
  return unit_open(x, u);
}

// Step 4's read half for unit u: its bytes jump once, into x.  Returns
// whether any changed.
SNAPPY_HD bool jump_unit(const Image& im, int u, Unit& x) {
  load_unit(im, u, x);
  bool changed = false;
  SNAPPY_UNROLL
  for (int e = 0; e < kUnit; ++e) {
    const uint32_t j = static_cast<uint32_t>(kUnit * u + e);
    const uint32_t k = ptr_of(x, e);
    if (k != j) {
      const uint32_t q = ptr_at(im, k);
      if (q == k) {
        set_val(x, e, out_at(im, k));
        set_ptr(x, e, j);
      } else {
        set_ptr(x, e, q);
      }
      changed = true;
    }
  }
  return changed;
}

// Steps 1-4 over the first nrun records of spans (ascending, as above; at
// most kNone of them).  Returns the rounds taken, 0 to 16 on every input
// the kernels take, or kMaxRounds + 1 if some byte was still unresolved
// after kMaxRounds.  out[] then holds the block's output.
template <class B, class Spans>
SNAPPY_HD int resolve(B& blk, const Image& im, const Spans& spans, int32_t nrun) {
  SNAPPY_RESOLVE_ASSERT(0 <= nrun && nrun <= static_cast<int32_t>(kNone));
  blk.each([&](int t) {  // 1. no marks
    const Unit none{{0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu}, {0, 0}};
    for (int k = 0; k < kUnitsPerThread; ++k) store_unit(im, t + k * kThreads, none);
  });
  blk.sync();
  blk.each([&](int t) {  // each record's first byte
    for (int32_t r = t; r < nrun; r += kThreads) {
      const Span sp = spans(r);
      if (sp.len > 0) {
        SNAPPY_RESOLVE_ASSERT(sp.dst >= kOutBase && sp.dst + sp.len <= kOutBase + kBlockSize);
        SNAPPY_RESOLVE_WATCH(im, write, im.ptr + (sp.dst - kOutBase), sizeof *im.ptr);
        im.ptr[sp.dst - kOutBase] = static_cast<uint16_t>(r);
      }
    }
  });
  blk.sync();
  int32_t carry = -1;  // 2. the scan, a tile of kThreads units at a time
  for (int k = 0; k < kUnitsPerThread; ++k) {
    typename B::template Var<int32_t> m;
    blk.each([&](int t) { m[t] = unit_max(im, k * kThreads + t); });
    const int32_t total = blk.excl_max_scan(m);
    blk.each([&](int t) { fill_unit(im, k * kThreads + t, m[t] > carry ? m[t] : carry); });
    carry = total > carry ? total : carry;
  }
  // 3. place: thread t filled exactly the units it places, so no barrier
  typename B::template Var<uint32_t> pending;  // bit k: unit t + k * kThreads is open
  blk.each([&](int t) {
    pending[t] = 0;
    for (int k = 0; k < kUnitsPerThread; ++k)
      if (place_unit(im, t + k * kThreads, spans)) pending[t] |= 1u << k;
  });
  typename B::template Var<bool> open;
  for (int rounds = 0;; ++rounds) {  // 4. the rounds
    blk.each([&](int t) { open[t] = pending[t] != 0; });
    if (!blk.any(open)) return rounds;
    if (rounds == kMaxRounds) return kMaxRounds + 1;
    for (int h = 0; h < kUnitsPerThread; h += kBatch) {
      typename B::template Var<Step> st;
      blk.each([&](int t) {  // the read half
        st[t].dirty = 0;
        SNAPPY_UNROLL
        for (int i = 0; i < kBatch; ++i)
          if ((pending[t] >> (h + i) & 1u) && jump_unit(im, t + (h + i) * kThreads, st[t].x[i]))
            st[t].dirty |= 1u << i;
      });
      blk.sync();
      blk.each([&](int t) {  // the write half
        SNAPPY_UNROLL
        for (int i = 0; i < kBatch; ++i) {
          if (!(st[t].dirty >> i & 1u)) continue;
          const int u = t + (h + i) * kThreads;
          store_unit(im, u, st[t].x[i]);
          if (!unit_open(st[t].x[i], u)) pending[t] &= ~(1u << (h + i));
        }
      });
      if (h + kBatch < kUnitsPerThread) blk.sync();  // the last write half meets any() next
    }
  }
}

// K6's plan for a tape of nrecs records (cap the tape's capacity): the
// records that run (those before the first one in_image refuses, none if
// nrecs is outside [0, cap]), ok, and whether the resolver is exact on them
// (each writes only the output region at or past the end of the one before,
// and there are at most kNone).  Each thread checks records t, t + kThreads,
// ...; the first refused and the first out of order are block minimums.
struct TapePlan {
  int32_t nrun;
  bool ok;
  bool exact;
};

template <class B, class Fetch>
SNAPPY_HD TapePlan plan_tape(B& blk, const Fetch& fetch, int32_t nrecs, int32_t cap) {
  if (nrecs < 0 || nrecs > cap) return TapePlan{0, false, true};
  typename B::template Var<int32_t> bad, unordered;
  blk.each([&](int t) {
    bad[t] = unordered[t] = nrecs;
    for (int32_t r = t; r < nrecs; r += kThreads) {
      const snappy_tape::Record x = fetch(r);
      if (!snappy_tape::in_image(x)) {  // records past it do not run
        bad[t] = r;
        break;
      }
      if (unordered[t] == nrecs) {
        bool follows = x.dst >= kOutBase;
        if (r > 0) {
          const snappy_tape::Record y = fetch(r - 1);
          follows = follows && x.dst >= y.dst + y.len;
        }
        if (!follows) unordered[t] = r;
      }
    }
  });
  const int32_t first_bad = blk.min(bad);
  const int32_t first_unordered = blk.min(unordered);
  return TapePlan{first_bad, first_bad == nrecs,
                  first_unordered >= first_bad && first_bad <= static_cast<int32_t>(kNone)};
}

struct Outcome {
  bool ok;
  int rounds;  // resolve's, or kWalked
};

// K6's body: the plan, then the resolver, or, for a tape the resolver is not
// exact on (only a hand-made one: every builder tape is ascending), walk(),
// which runs decode_tape.cuh's run_tape over the whole unified image and
// returns its ok.  The two are one function on different inputs, chosen per
// block from the records alone; the caller writes back out[] or the walk's
// image.
template <class B, class Fetch, class Walk>
SNAPPY_HD Outcome run_tape_block(B& blk, const Fetch& fetch, int32_t nrecs, int32_t cap, const Image& im,
                                 Walk& walk) {
  const TapePlan plan = plan_tape(blk, fetch, nrecs, cap);
  if (!plan.exact) return Outcome{walk(), kWalked};
  const int rounds = resolve(blk, im, TapeSpans<Fetch>{fetch}, plan.nrun);
  return Outcome{plan.ok && rounds <= kMaxRounds, rounds};
}

#ifdef __CUDACC__
// The block policy on the device: one thread per thread, kThreads of them.
// Its methods are __host__ __device__ only so that the templates above
// instantiate; the host side is never called.
struct DeviceBlock {
  template <class T>
  struct Var {
    T v;
    __host__ __device__ T& operator[](int) { return v; }
    __host__ __device__ const T& operator[](int) const { return v; }
  };
  BlockScratch* s;

  template <class F>
  __host__ __device__ void each(F f) {
#ifdef __CUDA_ARCH__
    f(static_cast<int>(threadIdx.x));
#endif
  }
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
  __host__ __device__ bool any(const Var<bool>& p) const {
#ifdef __CUDA_ARCH__
    return __syncthreads_or(p.v) != 0;
#else
    return p.v;
#endif
  }
  __host__ __device__ int32_t min(const Var<int32_t>& x) const {
#ifdef __CUDA_ARCH__
    const int32_t m = __reduce_min_sync(0xFFFFFFFFu, x.v);
    if ((threadIdx.x & 31) == 0) s->totals[threadIdx.x >> 5] = m;
    __syncthreads();
    int32_t r = s->totals[0];
    for (int w = 1; w < kThreads / 32; ++w) r = s->totals[w] < r ? s->totals[w] : r;
    __syncthreads();  // before the scratch is used again
    return r;
#else
    return x.v;
#endif
  }
  __host__ __device__ int32_t excl_max_scan(Var<int32_t>& x) const {
#ifdef __CUDA_ARCH__
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int32_t v = x.v;
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, v, d);
      if (lane >= d && y > v) v = y;
    }
    const int32_t below = __shfl_up_sync(0xFFFFFFFFu, v, 1);
    if (lane == 31) s->totals[warp] = v;
    __syncthreads();
    int32_t before = lane ? below : -1, total = -1;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int32_t t = s->totals[w];
      if (w < warp && t > before) before = t;
      if (t > total) total = t;
    }
    x.v = before;
    __syncthreads();  // before the scratch is used again
    return total;
#else
    return x.v;
#endif
  }
};
#endif  // __CUDACC__

}  // namespace snappy_resolve
