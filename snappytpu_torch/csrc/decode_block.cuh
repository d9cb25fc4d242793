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
// ctx_len is how many decoded bytes lie before the block's output: 0 for
// an independent block (K2, K3's parse, and this header's walk), up to
// 65536 for a chunk of the windowed decoder (K4's parse, the rule of
// decode_vm2.py `_block_loop.parse_at`).  Lengths outside the row (comp_len not in
// [0, 73728], out_len not in [0, 65536]) report not ok.  The rules
// (op_rules) are written once, over the cursors' width: 64-bit in this
// header's op-by-op walk (the host tests' statement of the accept set), 32-bit in the pipelined walk of
// decode_pipe.cuh (K2, K3, K4), where every value fits: ip <= 73728 + 64 (a
// window may look past comp_len), opc + ctx_len <= 131072, and
// ip + hdr + len < 2^31 because a 4-byte literal length is at most 2^30.
// parse_op reads no byte past the 73728-byte row.

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

// An op: Int is the width of the cursors, int64_t in this header's walk
// and int32_t in the pipelined walk of decode_pipe.cuh (K2, K3, K4).
template <class Int>
struct OpT {
  Int hdr;   // header bytes (tag + length/offset bytes)
  Int len;   // output bytes
  Int dist;  // copy distance; 0 for a literal (and for a bad copy)
  bool bad;
};
using Op = OpT<int64_t>;

// The rules, written once: the op whose header bytes are tag, b1..b4 (those
// past its header are not looked at), at comp byte ip with the output
// cursor at opc.
template <class Int>
SNAPPY_HD OpT<Int> op_rules(uint32_t tag, uint32_t b1, uint32_t b2, uint32_t b3, uint32_t b4, Int ip, Int opc,
                            Int comp_len, Int out_len, Int ctx_len) {
  const uint32_t kind = tag & 3u;
  const uint32_t code = tag >> 2;

  OpT<Int> op;
  bool bad;
  if (kind == 0) {  // literal; codes 60..63 carry 1..4 length bytes
    const uint32_t extra = code >= 60 ? code - 59 : 0;
    uint32_t m = code;
    if (extra == 1) m = b1;
    if (extra == 2) m = b1 | (b2 << 8);
    if (extra == 3) m = b1 | (b2 << 8) | (b3 << 16);
    if (extra == 4) m = b1 | (b2 << 8) | (b3 << 16) | ((b4 & 0x3Fu) << 24);
    op.hdr = 1 + extra;
    op.len = static_cast<Int>(m) + 1;
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

SNAPPY_HD uint32_t byte_at(const uint8_t* row, int64_t i) {
  return i < kPadOut ? row[i] : 0u;
}

// Decode the op at comp byte ip of an independent block with the output
// cursor at opc.
SNAPPY_HD Op parse_op(const uint8_t* row, int64_t ip, int64_t opc, int64_t comp_len, int64_t out_len) {
  return op_rules<int64_t>(byte_at(row, ip), byte_at(row, ip + 1), byte_at(row, ip + 2), byte_at(row, ip + 3),
                           byte_at(row, ip + 4), ip, opc, comp_len, out_len, int64_t{0});
}

// Run one block's ops in order, one op at a time.  The mover places the bytes:
//   mv.literal(opc, src, len): out[opc + j] = row[src + j]
//   mv.copy(opc, dist, len):   out[opc + j] = out[opc + j - dist], byte-forward
// Returns the ok flag.
template <class Mover>
SNAPPY_HD bool decode_block(const uint8_t* row, int64_t comp_len, int64_t out_len, Mover& mv) {
  if (comp_len < 0 || comp_len > kPadOut || out_len < 0 || out_len > kBlockSize) return false;
  int64_t ip = 0;
  int64_t opc = 0;
  while (opc < out_len && ip < comp_len) {
    const Op op = parse_op(row, ip, opc, comp_len, out_len);
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
