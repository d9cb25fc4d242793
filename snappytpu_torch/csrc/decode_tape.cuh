// Movement tapes: the record format of the host tape builder
// (snappytpu/cpu/csrc/snappy_cpu.cc `stpu_build_tape`) and how one record
// moves bytes inside a block's unified image.  Shared by the CUDA kernel
// (decode_tape.cu) and any host build of the same source: under nvcc every
// function is __host__ __device__, under a host compiler plain inline C++.
//
// The unified image is the TPU kernel's (snappytpu/kernels/decode_vm2.py
// COMP_OFF / OUT_BASE), because the host builder writes image addresses:
//   [0, 512)          guard, zero
//   [512, 74240)      the block's 73728-byte compressed row
//   [74240, 139776)   the 65536-byte output, zero before the first record
// A record is two int32 words, w0 = src | pk2 << 18 | len << 20 and
// w1 = dst.  pk2 0 is a copy of len bytes from src to dst; pk2 1/2/3 is a
// fill of period p = 1/2/4: img[dst + j] = img[dst - p + j % p]
// (decode_vm2.py `_piece` and `_pattern`).
//
// The builder's records lie inside the image, and a copy's source never
// overlaps its destination (src + len <= dst, or src in the compressed
// region), so the lanes of a warp may move a record's bytes in any order.
// A record that breaks either rule (len > 504, a source or destination
// outside [0, 139776), an overlapping copy) stops the walk and the block
// reports not ok: no tape can make the kernel read or write outside its
// image, and every accepted record moves the same bytes in any order.

#pragma once

#include <stdint.h>

#include "decode_block.cuh"
#include "decode_pipe.cuh"

namespace snappy_tape {

constexpr int64_t kCompOff = 512;
constexpr int64_t kOutBase = kCompOff + snappy_block::kPadOut;        // 74240
constexpr int64_t kImageBytes = kOutBase + snappy_block::kBlockSize;  // 139776
constexpr int64_t kPieceMax = 504;  // the builder's longest record
constexpr int kLanes = 32;

struct Record {
  int64_t src;
  int64_t dst;
  int64_t len;
  int64_t period;  // 0 for a copy, else 1, 2 or 4
};

SNAPPY_HD Record decode_record(int32_t w0, int32_t w1) {
  const uint32_t u = static_cast<uint32_t>(w0);
  const uint32_t pk2 = (u >> 18) & 3u;
  Record r;
  r.src = u & 0x3FFFFu;
  r.len = u >> 20;
  r.period = pk2 == 3 ? 4 : pk2;
  r.dst = w1;
  return r;
}

SNAPPY_HD bool in_image(const Record& r) {
  if (r.len > kPieceMax || r.dst < 0 || r.dst + r.len > kImageBytes) return false;
  if (r.period != 0) return r.dst >= r.period;
  return r.src + r.len <= kImageBytes && (r.src + r.len <= r.dst || r.dst + r.len <= r.src);
}

// One lane's share of an accepted record: bytes lane, lane + 32, ...  The
// period is 1, 2 or 4, so j & (p - 1) is j % p.
SNAPPY_HD void lane_move(uint8_t* img, const Record& r, int lane) {
  const int len = static_cast<int>(r.len);
  const int dst = static_cast<int>(r.dst);
  if (r.period == 0) {
    const int src = static_cast<int>(r.src);
    for (int j = lane; j < len; j += kLanes) img[dst + j] = img[src + j];
  } else {
    const int p = static_cast<int>(r.period);
    for (int j = lane; j < len; j += kLanes) img[dst + j] = img[dst - p + (j & (p - 1))];
  }
}

// Walk a block's tape: fetch(r) gives record r, move(rec) moves its bytes.
// ok = 0 <= nrecs <= cap and every record passes in_image.
template <class Fetch, class Move>
SNAPPY_HD bool run_tape(int64_t nrecs, int64_t cap, Fetch& fetch, Move& move) {
  if (nrecs < 0 || nrecs > cap) return false;
  for (int64_t r = 0; r < nrecs; ++r) {
    const Record rec = fetch(r);
    if (!in_image(rec)) return false;
    move(rec);
  }
  return true;
}

// K5's producer: the tape of a block with 0 <= nrecs <= cap records, 32 per
// step, one per lane; load(w, r, w0, w1) gives lane l record r + l's two
// words (zeros past nrecs), and the next step's are loaded before this one
// is handed over.  Each lane checks its record (in_image); a ballot finds
// the first one refused, and the records before it go to sink (room(n) ->
// a slot with room for n, commit(n), finish(), as the judge's sink of
// decode_pipe.cuh) as decode_pipe.cuh's Recs in image coordinates, for
// move_batch with comp = out = img:
//   a copy  {dst, src, len, dst - src}
//   a fill  {dst, dst - p, len, p}
// move_batch is exact on a batch whose records are contiguous (each dst is
// the previous dst + len) and read only bytes before their dst, which every
// builder tape's batches are: it joins a run of pieces at one distance into
// one record and cuts the batch into groups that read nothing they write.
// A batch that is not so (a tape the builder never writes) goes one record
// per batch instead, a copy as {dst, src, len, 0}, which move_batch moves as
// a literal from img + src: one group per record, the walk of run_tape.
// Returns the ok flag: run_tape's, and the moves are run_tape's too.
template <class W, class Load, class Sink>
SNAPPY_HD bool produce_tape(W& w, int32_t nrecs, Load& load, Sink& sink) {
  using snappy_pipe::Rec;
  using VI = typename W::template Var<int32_t>;
  using VB = typename W::template Var<bool>;
  using VR = typename W::template Var<Rec>;
  VI w0, w1, n0, n1, end, prev;
  VB bad, brk;
  VR rec, one;
  bool good = true;
  load(w, 0, w0, w1);
  for (int32_t r0 = 0; r0 < nrecs; r0 += kLanes) {
    load(w, r0 + kLanes, n0, n1);
    w.each([&](int l) { bad[l] = r0 + l < nrecs && !in_image(decode_record(w0[l], w1[l])); });
    const uint32_t refused = w.ballot(bad);
    const int n = refused ? snappy_pipe::lowest(refused) : (nrecs - r0 < kLanes ? nrecs - r0 : kLanes);
    w.each([&](int l) {  // lanes below n hold accepted records, whose sums cannot overflow
      const Record x = decode_record(w0[l], w1[l]);
      const int32_t dst = w1[l], len = static_cast<int32_t>(x.len), src = static_cast<int32_t>(x.src);
      const int32_t p = static_cast<int32_t>(x.period);
      if (l >= n || len == 0) {
        rec[l] = one[l] = Rec{l < n ? dst : 0, 0, 0, 0};
      } else if (p) {
        rec[l] = one[l] = Rec{dst, dst - p, len, p};
      } else {
        rec[l] = Rec{dst, src, len, dst - src};
        one[l] = Rec{dst, src, len, 0};
      }
      end[l] = rec[l].dst + rec[l].len;
      prev[l] = l > 0 ? l - 1 : 0;
    });
    const VI prev_end = w.gather(end, prev);
    w.each([&](int l) { brk[l] = l < n && ((l > 0 && rec[l].dst != prev_end[l]) || rec[l].dist < 0); });
    if (n && !w.ballot(brk)) {
      Rec* slot = sink.room(snappy_pipe::kBatch);  // a batch of its own
      w.each([&](int l) {
        if (l < n) slot[l] = rec[l];
      });
      sink.commit(n);
    } else {
      for (int i = 0; i < n; ++i) {
        Rec* slot = sink.room(snappy_pipe::kBatch);
        w.each([&](int l) {
          if (l == i) slot[0] = one[l];
        });
        sink.commit(1);
      }
    }
    if (refused) {
      good = false;
      break;
    }
    w0 = n0;
    w1 = n1;
  }
  sink.finish();
  return good;
}

#ifdef __CUDACC__
// K6's fetch and move (decode_tape.cu; K5's walk until the producer above
// took its place), also the `full-D1` mode of the tape probe T3
// (tape_probe.cu).  Records r..r+31 are loaded by the 32 lanes when
// r reaches a multiple of 32; record r is then shuffled from lane r % 32.
// The tape is walked in order, so every lane calls this with the same r.
// __host__ __device__ only so that the shared walk instantiates; the host
// side is never called.
struct WarpFetch {
  const int2* tape;
  int64_t nrecs;
  int lane;
  int2 held;

  __host__ __device__ Record operator()(int64_t r) {
#ifdef __CUDA_ARCH__
    if ((r & 31) == 0) {
      const int64_t i = r + lane;
      held = i < nrecs ? tape[i] : make_int2(0, 0);
    }
    const int k = static_cast<int>(r & 31);
    return decode_record(__shfl_sync(0xFFFFFFFFu, held.x, k), __shfl_sync(0xFFFFFFFFu, held.y, k));
#else
    return Record{};
#endif
  }
};

struct WarpMove {
  uint8_t* img;
  int lane;

  __host__ __device__ void operator()(const Record& r) {
#ifdef __CUDA_ARCH__
    lane_move(img, r, lane);
    __syncwarp();
#endif
  }
};
#endif  // __CUDACC__

}  // namespace snappy_tape
