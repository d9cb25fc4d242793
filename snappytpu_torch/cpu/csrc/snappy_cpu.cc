// snappytpu native host runtime: CPU Snappy codec, raw-stream scanner, and
// stream compaction.
//
// Role in the framework (SURVEY.md §7): the host-side golden oracle and fast
// fallback for the TPU codec — NOT a copy of the reference C code.  It is an
// independent implementation of the public Snappy block format (the same
// format the reference implements in src/snappy_compression.c /
// src/snappy_decompression.c), written for clarity + host speed:
//   * compress: greedy LZ77 over 64 KiB blocks, 15-bit last-occurrence table,
//     miss-acceleration stepping, unaligned 64-bit loads for match extension
//   * decompress: fully validated (offset/length/bounds) streaming decode
//   * scan_ops: op-boundary walk that cuts a raw stream into per-64KiB-output
//     chunks for block-parallel device decode
//   * compact: gather variable-length per-block outputs into one stream
//
// Exposed with a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kBlockSize = 65536;
constexpr int kMaxCopyLen = 64;
constexpr int kMinMatch = 4;
constexpr int kTableBits = 15;
constexpr int kTableSize = 1 << kTableBits;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t hash32(uint32_t v) { return (v * 0x1e35a7bd) >> (32 - kTableBits); }

inline uint8_t* emit_literal(uint8_t* dst, const uint8_t* src, int len) {
  int n = len - 1;
  if (len <= 60) {
    *dst++ = static_cast<uint8_t>(n << 2);
  } else if (n < 256) {
    *dst++ = 60 << 2;
    *dst++ = static_cast<uint8_t>(n);
  } else {
    *dst++ = 61 << 2;
    *dst++ = static_cast<uint8_t>(n & 0xff);
    *dst++ = static_cast<uint8_t>(n >> 8);
  }
  std::memcpy(dst, src, len);
  return dst + len;
}

inline uint8_t* emit_copy_op(uint8_t* dst, int len, int offset) {
  if (len >= kMinMatch && len <= 11 && offset < 2048) {
    *dst++ = static_cast<uint8_t>(((offset >> 8) << 5) | ((len - 4) << 2) | 1);
    *dst++ = static_cast<uint8_t>(offset & 0xff);
  } else {
    *dst++ = static_cast<uint8_t>(((len - 1) << 2) | 2);
    *dst++ = static_cast<uint8_t>(offset & 0xff);
    *dst++ = static_cast<uint8_t>(offset >> 8);
  }
  return dst;
}

// split a long match into <=64-byte ops, keeping the final op >= kMinMatch
inline uint8_t* emit_copy(uint8_t* dst, int len, int offset) {
  while (len >= kMaxCopyLen + kMinMatch) {
    dst = emit_copy_op(dst, kMaxCopyLen, offset);
    len -= kMaxCopyLen;
  }
  if (len > kMaxCopyLen) {
    dst = emit_copy_op(dst, 60, offset);
    len -= 60;
  }
  return emit_copy_op(dst, len, offset);
}

int compress_block(const uint8_t* src, int n, uint8_t* dst, uint16_t* table) {
  uint8_t* out = dst;
  std::memset(table, 0, kTableSize * sizeof(uint16_t));
  if (n < kMinMatch + 1) {
    if (n > 0) out = emit_literal(out, src, n);
    return static_cast<int>(out - dst);
  }
  int lit_start = 0;
  int p = 1;  // position 0 has no previous occurrence; also lets 0 mean "empty"
  const int limit = n - kMinMatch;  // last position where a match can start
  while (p <= limit) {
    // skip acceleration: after 32 misses probe every 2nd byte, then 4th...
    uint32_t skip = 32;
    int q = p;
    int cand = 0;
    uint32_t v = 0;
    bool found = false;
    while (q <= limit) {
      v = load32(src + q);
      uint32_t h = hash32(v);
      cand = table[h];
      table[h] = static_cast<uint16_t>(q);
      if (cand < q && load32(src + cand) == v) {
        found = true;
        break;
      }
      q += (skip++ >> 5);
    }
    if (!found) break;
    // extend match
    int len = kMinMatch;
    {
      int a = q + kMinMatch, b = cand + kMinMatch;
      while (a + 8 <= n) {
        uint64_t x = load64(src + a) ^ load64(src + b);
        if (x) {
          len += __builtin_ctzll(x) >> 3;
          goto extended;
        }
        a += 8;
        b += 8;
        len += 8;
      }
      while (a < n && src[a] == src[b]) {
        ++a;
        ++b;
        ++len;
      }
    }
  extended:
    if (q > lit_start) out = emit_literal(out, src + lit_start, q - lit_start);
    out = emit_copy(out, len, q - cand);
    // seed the table inside the match region (sparse, every 4th byte)
    for (int s = q + 1; s + kMinMatch <= q + len && s <= limit; s += 4) {
      table[hash32(load32(src + s))] = static_cast<uint16_t>(s);
    }
    p = q + len;
    lit_start = p;
  }
  if (n > lit_start) out = emit_literal(out, src + lit_start, n - lit_start);
  return static_cast<int>(out - dst);
}

int put_varint(uint8_t* dst, uint64_t v) {
  int i = 0;
  while (v >= 0x80) {
    dst[i++] = static_cast<uint8_t>(v & 0x7f) | 0x80;
    v >>= 7;
  }
  dst[i++] = static_cast<uint8_t>(v);
  return i;
}

int get_varint(const uint8_t* src, int64_t n, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0, i = 0;
  while (i < n && i < 10) {
    uint8_t b = src[i++];
    v |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return i;
    }
    shift += 7;
  }
  return -1;
}

}  // namespace

extern "C" {

// Worst-case compressed bound for n input bytes.  The adversarial ratio of
// a greedy parse is 66/65 (length-61 literal runs, 2-byte headers,
// interleaved with 3-byte copies covering 4 bytes); n/6 + 32 covers it with
// the same shape google/snappy uses for MaxCompressedLength.
int64_t stpu_max_compressed(int64_t n) { return 32 + n + n / 6; }

// Compress n bytes into dst (raw Snappy stream with preamble).
// Returns compressed size, or -1 if dst_cap is too small.
int64_t stpu_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                      int64_t dst_cap) {
  if (dst_cap < stpu_max_compressed(n)) return -1;
  uint16_t table[kTableSize];
  uint8_t* out = dst + put_varint(dst, static_cast<uint64_t>(n));
  for (int64_t start = 0; start < n; start += kBlockSize) {
    int len = static_cast<int>(n - start < kBlockSize ? n - start : kBlockSize);
    out += compress_block(src + start, len, out, table);
  }
  return out - dst;
}

// Decompress a raw stream (with preamble).  Writes exactly *out_len bytes;
// dst_cap must be >= declared size + 8 (the overlap fast path copies in
// 8-byte chunks and may touch up to 7 bytes of slack past the end).
// Returns 0 on success; negative error codes on malformed input.
int64_t stpu_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t dst_cap, int64_t* out_len) {
  uint64_t total;
  int pre = get_varint(src, n, &total);
  if (pre < 0) return -1;
  if (static_cast<int64_t>(total) + 8 > dst_cap) return -2;
  const uint8_t* p = src + pre;
  const uint8_t* end = src + n;
  uint8_t* w = dst;
  uint8_t* wend = dst + total;
  while (w < wend) {
    if (p >= end) return -3;  // truncated
    uint32_t tag = *p;
    uint32_t kind = tag & 3;
    if (kind == 0) {  // literal
      uint32_t code = tag >> 2;
      uint64_t len;
      int hdr;
      if (code < 60) {
        len = code + 1;
        hdr = 1;
      } else {
        hdr = 1 + (code - 59);
        if (p + hdr > end) return -3;
        len = 0;
        for (int i = 0; i < hdr - 1; ++i)
          len |= static_cast<uint64_t>(p[1 + i]) << (8 * i);
        ++len;
      }
      if (p + hdr + len > end) return -3;
      if (w + len > wend) return -4;  // overruns declared output
      std::memcpy(w, p + hdr, len);
      w += len;
      p += hdr + len;
    } else {
      uint32_t len, offset;
      if (kind == 1) {
        if (p + 2 > end) return -3;
        len = ((tag >> 2) & 0x7) + 4;
        offset = ((tag >> 5) << 8) | p[1];
        p += 2;
      } else if (kind == 2) {
        if (p + 3 > end) return -3;
        len = (tag >> 2) + 1;
        offset = p[1] | (p[2] << 8);
        p += 3;
      } else {
        if (p + 5 > end) return -3;
        len = (tag >> 2) + 1;
        offset = static_cast<uint32_t>(p[1]) | (p[2] << 8) | (p[3] << 16) |
                 (static_cast<uint32_t>(p[4]) << 24);
        p += 5;
      }
      if (offset == 0 || offset > static_cast<uint64_t>(w - dst)) return -5;
      if (w + len > wend) return -4;
      const uint8_t* r = w - offset;
      if (offset >= len) {
        std::memcpy(w, r, len);  // disjoint
      } else if (offset >= 8) {
        // 8-byte chunks never read bytes written in the same chunk
        for (uint32_t i = 0; i < len; i += 8) std::memcpy(w + i, r + i, 8);
      } else {
        // tiny period: replicate pattern-doubling style, byte-safe first
        uint32_t i = 0;
        for (; i < offset && i < len; ++i) w[i] = r[i];
        for (; i < len; ++i) w[i] = w[i - offset];
      }
      w += len;
    }
  }
  if (p != end) return -6;  // trailing garbage
  *out_len = w - dst;
  return 0;
}

// Walk op boundaries of a raw op stream (no preamble) producing per-block
// cuts: comp_offsets[i] = byte offset where block i's ops start,
// out_lens[i] = bytes block i decodes to (<= block_size, op-aligned).
// Returns number of blocks, or negative on malformed/unsplittable stream.
int64_t stpu_scan_ops(const uint8_t* src, int64_t n, int64_t total_out,
                      int64_t block_size, int64_t* comp_offsets,
                      int64_t* out_lens, int64_t max_blocks) {
  int64_t p = 0, w = 0, nb = 0;
  int64_t chunk_start = 0, chunk_out = 0;
  while (w < total_out) {
    if (p >= n) return -3;
    uint32_t tag = src[p];
    uint32_t kind = tag & 3;
    int64_t out, adv;
    if (kind == 0) {
      uint32_t code = tag >> 2;
      if (code < 60) {
        out = code + 1;
        adv = 1 + out;
      } else {
        int hdr = 1 + (code - 59);
        if (p + hdr > n) return -3;
        uint64_t len = 0;
        for (int i = 0; i < hdr - 1; ++i)
          len |= static_cast<uint64_t>(src[p + 1 + i]) << (8 * i);
        out = static_cast<int64_t>(len) + 1;
        adv = hdr + out;
      }
    } else if (kind == 1) {
      out = ((tag >> 2) & 0x7) + 4;
      adv = 2;
    } else if (kind == 2) {
      out = (tag >> 2) + 1;
      adv = 3;
    } else {
      out = (tag >> 2) + 1;
      adv = 5;
    }
    if (chunk_out + out > block_size) return -7;  // op straddles boundary
    p += adv;
    w += out;
    chunk_out += out;
    if (chunk_out == block_size || w == total_out) {
      if (nb >= max_blocks) return -8;
      comp_offsets[nb] = chunk_start;
      out_lens[nb] = chunk_out;
      ++nb;
      chunk_start = p;
      chunk_out = 0;
    }
  }
  if (p != n) return -6;
  if (nb == 0 && max_blocks > 0) {
    comp_offsets[0] = 0;
    out_lens[0] = 0;
    nb = 1;
  }
  return nb;
}

// Build a movement tape for the Pallas movement-only decoder
// (kernels/decode_tape.py): parse + validate one block's op stream on the
// host and emit the EXACT piece schedule the device VM would compute
// (decode_vm2.py piece semantics: 504-byte funnel windows, same-distance
// chain coalescing, dist-{1,2,4} pattern pieces, period-multiple doubling
// for other self-overlaps), so the device kernel runs pure data movement
// with zero on-device parsing.  Replaces the decode VM's scalar parse
// chain (~94 ns/op of dependent-latency, PROFILE.md r4) with host C.
//
// Record: two int32 words.  w0 = src | pk2 << 18 | len << 20 (src < 2^18
// image bytes, pk2 = pattern dist code 0/1/2/3->{none,1,2,4}, len <= 504);
// w1 = dst image byte.  comp_off / out_base are the caller's unified-image
// layout constants.
//
// Returns n_records >= 0, or -9 (tape capacity; caller falls back to the
// parsing VM) or -10 (malformed stream: the same accept set as the VM —
// differential-tested; caller flags the block bad).
int64_t stpu_build_tape(const uint8_t* comp, int64_t stride, int64_t comp_len,
                        int64_t out_len, int64_t comp_off, int64_t out_base,
                        int32_t* tape, int64_t max_recs) {
  constexpr int64_t kPieceMax = 504;
  int64_t nrec = 0;
  int64_t ip = 0, opc = 0;

  // parse the op at ip with the output cursor at opc_eff; identical accept
  // set to decode_vm2._block_loop.parse_at with ctx_len = 0
  auto parse = [&](int64_t at, int64_t opc_eff, int64_t* hdr, int64_t* ln,
                   int64_t* d) -> bool {  // returns bad
    auto byte_at = [&](int64_t i) -> uint32_t {
      return (i < stride) ? comp[i] : 0u;
    };
    uint32_t tag = byte_at(at);
    uint32_t kind = tag & 3;
    uint32_t code = tag >> 2;
    bool bad = false;
    if (kind == 0) {  // literal
      int64_t extra = (code < 60) ? 0 : (code - 59);
      *hdr = 1 + extra;
      uint64_t len = code + 1;
      if (extra > 0) {
        len = 0;
        for (int64_t i = 0; i < extra; ++i)
          len |= static_cast<uint64_t>(byte_at(at + 1 + i)) << (8 * i);
        if (extra == 4) {
          bad |= (byte_at(at + 4) & 0xC0) != 0;  // match the VM's 30-bit cap
          len &= 0x3FFFFFFF;
        }
        len += 1;
      }
      *ln = static_cast<int64_t>(len);
      *d = 0;
      bad |= (at + *hdr > comp_len) || (opc_eff + *ln > out_len);
      bad |= (at + *hdr + *ln > comp_len);
    } else {
      if (kind == 1) {
        *hdr = 2;
        *ln = (code & 7) + 4;
        *d = ((code >> 3) << 8) | byte_at(at + 1);
      } else if (kind == 2) {
        *hdr = 3;
        *ln = code + 1;
        *d = byte_at(at + 1) | (byte_at(at + 2) << 8);
      } else {
        *hdr = 5;
        *ln = code + 1;
        *d = byte_at(at + 1) | (byte_at(at + 2) << 8) | (byte_at(at + 3) << 16);
        bad |= byte_at(at + 4) != 0;
      }
      bad |= (at + *hdr > comp_len) || (opc_eff + *ln > out_len);
      bad |= (*d < 1) || (*d > opc_eff);
    }
    return bad;
  };

  auto emit = [&](int64_t s, int64_t dst, int64_t lp, int64_t patk) -> bool {
    if (nrec >= max_recs) return false;
    int32_t pk2 = (patk == 4) ? 3 : static_cast<int32_t>(patk);
    tape[2 * nrec] = static_cast<int32_t>(s) | (pk2 << 18) |
                     (static_cast<int32_t>(lp) << 20);
    tape[2 * nrec + 1] = static_cast<int32_t>(dst);
    ++nrec;
    return true;
  };

  while (opc < out_len && ip < comp_len) {
    int64_t hdr, ln, d;
    if (parse(ip, opc, &hdr, &ln, &d)) return -10;
    int64_t rem, src = 0, dist = d, done = 0;
    if (d == 0) {
      src = ip + hdr + comp_off;
      rem = ln;
      ip += hdr + ln;
    } else {
      // same-distance chain coalescing (decode_vm2.py:249-265): absorb the
      // 60/64-chunk tails of long matches and run streams into one move
      int64_t ip_a = ip + hdr, rem_a = ln;
      bool chainable = (d == 1) || (d == 2) || (d == 4) || (ln == kMaxCopyLen);
      while (chainable && ip_a < comp_len) {
        int64_t h2, l2, d2;
        bool bad2 = parse(ip_a, opc + rem_a, &h2, &l2, &d2);
        if (bad2 || d2 != d) break;
        ip_a += h2;
        rem_a += l2;
      }
      rem = rem_a;
      ip = ip_a;
    }
    while (rem > 0) {
      int64_t lp = rem < kPieceMax ? rem : kPieceMax;
      bool okr;
      if (dist == 0) {
        okr = emit(src, out_base + opc, lp, 0);
        src += lp;
      } else if (dist == 1 || dist == 2 || dist == 4) {
        okr = emit(0, out_base + opc, lp, dist);
      } else {
        int64_t dd = done - done % dist + dist;
        if (lp > dd) lp = dd;
        okr = emit(out_base + opc - dd, out_base + opc, lp, 0);
        done += lp;
      }
      if (!okr) return -9;
      opc += lp;
      rem -= lp;
    }
  }
  if (ip != comp_len || opc != out_len) return -10;
  return nrec;
}

// Gather B variable-length rows (row i = comp[i*stride .. i*stride+lens[i]))
// into dst contiguously.  Returns total bytes written.
int64_t stpu_compact(const uint8_t* comp, int64_t stride, const int32_t* lens,
                     int64_t nrows, uint8_t* dst, int64_t dst_cap) {
  int64_t w = 0;
  for (int64_t i = 0; i < nrows; ++i) {
    int64_t len = lens[i];
    if (w + len > dst_cap) return -1;
    std::memcpy(dst + w, comp + i * stride, len);
    w += len;
  }
  return w;
}

// Scatter a contiguous byte stream into fixed-stride zero-padded rows.
// cuts[i] = start offset of row i, lens written as int32.  Returns 0.
int64_t stpu_split(const uint8_t* src, int64_t n, const int64_t* cuts,
                   int64_t nrows, uint8_t* rows, int64_t stride,
                   int32_t* lens) {
  for (int64_t i = 0; i < nrows; ++i) {
    int64_t end = (i + 1 < nrows) ? cuts[i + 1] : n;
    int64_t len = end - cuts[i];
    if (len > stride) return -1;
    std::memcpy(rows + i * stride, src + cuts[i], len);
    if (len < stride) std::memset(rows + i * stride + len, 0, stride - len);
    lens[i] = static_cast<int32_t>(len);
  }
  return 0;
}

}  // extern "C"
