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

}  // namespace snappy_tape
