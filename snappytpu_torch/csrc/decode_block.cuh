// Snappy block decode: the op parser, its validation and the decode loop,
// shared by the CUDA kernel (decode_block.cu) and any host build of the same
// source.  Under nvcc every function is __host__ __device__; under a host
// compiler it is plain inline C++, so the accept set can be checked without
// a GPU.
//
// The accept set is exactly that of the TPU block decoder
// (snappytpu/kernels/decode_vm4.py `_parse_at`, its loop condition and its
// ok flag):
//   * ip + hdr > comp_len                        -> bad
//   * opc + len > out_len                        -> bad
//   * a literal's bytes past comp_len            -> bad
//   * a copy with dist < 1 or dist > opc + ctx_len -> bad
//   * COPY4 with a nonzero 4th offset byte       -> bad
//   * a 4-byte-length literal with b4 & 0xC0     -> bad
//   * the loop runs while opc < out_len and ip < comp_len
//   * ok = no bad op, ip == comp_len and opc == out_len
// ctx_len is how many decoded bytes lie before the block's output: 0 for an
// independent block (K2), up to 65536 for a chunk of the windowed decoder
// (K4, the rule of decode_vm2.py `_block_loop.parse_at`).  Lengths outside
// the row (comp_len not in [0, 73728], out_len not in [0, 65536]) report
// not ok.  All bounds arithmetic is 64-bit (a 4-byte
// literal length reaches 2^30), and no byte past the 73728-byte row is read.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SNAPPY_HD __host__ __device__ __forceinline__
#else
#define SNAPPY_HD inline
#endif

namespace snappy_block {

constexpr int64_t kBlockSize = 65536;  // output bytes per block
constexpr int64_t kPadOut = 73728;     // compressed row bytes per block

struct Op {
  int64_t hdr;   // header bytes (tag + length/offset bytes)
  int64_t len;   // output bytes
  int64_t dist;  // copy distance; 0 for a literal
  bool bad;
};

SNAPPY_HD uint32_t byte_at(const uint8_t* row, int64_t i) {
  return i < kPadOut ? row[i] : 0u;
}

// Decode the op at comp byte ip with the output cursor at opc.
SNAPPY_HD Op parse_op(const uint8_t* row, int64_t ip, int64_t opc, int64_t comp_len,
                      int64_t out_len, int64_t ctx_len) {
  const uint32_t tag = byte_at(row, ip);
  const uint32_t b1 = byte_at(row, ip + 1);
  const uint32_t b2 = byte_at(row, ip + 2);
  const uint32_t b3 = byte_at(row, ip + 3);
  const uint32_t b4 = byte_at(row, ip + 4);
  const uint32_t kind = tag & 3u;
  const uint32_t code = tag >> 2;

  Op op;
  bool bad;
  if (kind == 0) {  // literal; codes 60..63 carry 1..4 length bytes
    const uint32_t extra = code >= 60 ? code - 59 : 0;
    uint32_t m = code;
    if (extra == 1) m = b1;
    if (extra == 2) m = b1 | (b2 << 8);
    if (extra == 3) m = b1 | (b2 << 8) | (b3 << 16);
    if (extra == 4) m = b1 | (b2 << 8) | (b3 << 16) | ((b4 & 0x3Fu) << 24);
    op.hdr = 1 + extra;
    op.len = static_cast<int64_t>(m) + 1;
    op.dist = 0;
    bad = ip + op.hdr + op.len > comp_len || (extra == 4 && (b4 & 0xC0u) != 0);
  } else {
    if (kind == 1) {  // COPY1
      op.hdr = 2;
      op.len = (code & 7u) + 4;
      op.dist = ((code >> 3) << 8) | b1;
    } else if (kind == 2) {  // COPY2
      op.hdr = 3;
      op.len = code + 1;
      op.dist = b1 | (b2 << 8);
    } else {  // COPY4: the 4th offset byte must be zero
      op.hdr = 5;
      op.len = code + 1;
      op.dist = b1 | (b2 << 8) | (b3 << 16);
    }
    bad = op.dist < 1 || op.dist > opc + ctx_len || (kind == 3 && b4 != 0);
  }
  op.bad = bad || ip + op.hdr > comp_len || opc + op.len > out_len;
  return op;
}

// Run one block's ops in order.  The mover places the bytes:
//   mv.literal(opc, src, len): out[opc + j] = row[src + j]
//   mv.copy(opc, dist, len):   out[opc + j] = out[opc + j - dist], byte-forward
// (a copy may reach ctx_len bytes before out[0]).  Returns the ok flag.
template <class Mover>
SNAPPY_HD bool decode_block(const uint8_t* row, int64_t comp_len, int64_t out_len, int64_t ctx_len,
                            Mover& mv) {
  if (comp_len < 0 || comp_len > kPadOut || out_len < 0 || out_len > kBlockSize) return false;
  int64_t ip = 0;
  int64_t opc = 0;
  while (opc < out_len && ip < comp_len) {
    const Op op = parse_op(row, ip, opc, comp_len, out_len, ctx_len);
    if (op.bad) return false;
    if (op.dist == 0) {
      mv.literal(opc, ip + op.hdr, op.len);
      ip += op.hdr + op.len;
    } else {
      mv.copy(opc, op.dist, op.len);
      ip += op.hdr;
    }
    opc += op.len;
  }
  return ip == comp_len && opc == out_len;
}

}  // namespace snappy_block
