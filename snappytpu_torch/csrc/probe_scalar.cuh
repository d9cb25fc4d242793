// The bodies of T1's scalar-chain probes (probe_scalar.cu), written once
// over decode_pipe.cuh's warp policy W so that g++ checks here the source
// that nvcc builds (tests/test_torch_probe_scalar_host.py runs every shape
// with the 32 lanes one by one, in reverse).
//
// Each probe runs one chain of n steps inside one warp and leaves the
// chain's final value in an (8, 128) int32 tile laid out as the TPU
// kernel's; the plain versions in snappytpu_torch/tools/probe_scalar.py
// compute the same tiles.  How each TPU primitive maps onto Hopper:
//   * SMEM scalar loads (x = smem[x]) -> one thread chasing through shared
//     memory (smem_chase, smem_unroll, smem_par, while_unroll with its
//     data-dependent exit, bigstate_par's chase);
//   * scalar reads of VMEM -> one thread chasing through global memory
//     (vmem_scalar; the 64 KiB table stays in L1 after the first pass);
//   * (2, 128) dynamic row reads and writes of a (128, 128) int32 VMEM ref ->
//     the warp reading or writing a dynamic pair of 512-byte shared-memory
//     rows, lane l owning words l, l + 32, l + 64, l + 96 of each row
//     (coalesced, no bank conflicts).  Lane l touches only its own columns,
//     so a row read-modify-write chain needs no __syncwarp.  The next row
//     index comes from the scalar chain, which every lane computes, except
//     in dynrow_chain, where it is lane 0's word taken by shfl (the TPU
//     kernel's vector-to-scalar extraction); there the row's other words
//     are read through a volatile pointer, so that the whole row is loaded;
//   * rmw_chain_same, the JAX tool's "v2 merge pattern ... the suspected
//     serializer", is on Hopper the mover's group close (decode_pipe.cuh
//     move_batch): at each step lane l takes the columns
//     ((l + (x & 31)) & 31) + 32 k of the row pair, so that it reads words
//     other lanes wrote, and one w.sync() comes before the step's reads.
//     Within a step a column belongs to one lane, so the read of pair x and
//     the write of pair 7x & 63 need nothing between them, and the tile is
//     the lane-owned one (a word's value does not depend on which lane
//     moved it).  split_ref_chain makes the same moves lane-owned and
//     without a sync: the difference per step is one group close;
//   * pltpu.roll along the 128 lanes -> a gather (__shfl_sync) rotate of the
//     (8, 128) tile held in registers, 32 words per lane (vec_chain with
//     rollit);
//   * scalar and vector ALU chains -> the same arithmetic in 32-bit unsigned
//     registers (int32 wrap-around, as the TPU's).
// Scratch refs the TPU kernels never initialise (dynrow_write, dynrow_par,
// dynrmw_par, split_ref_chain, rmw_chain_same) are zeroed by the kernel
// first; a `& 63` row chain touches rows 0-64, so each scratch holds 66
// rows, and six of them fit in shared memory (202,752 bytes) where six
// (128, 128) refs would not.
//
// A probe P gives kStage (input words the kernel stages to shared memory),
// kZero (zeroed scratch words after them), kScalar (the result is tile[0]
// alone) and run(w, in, s, n, tile).  A scalar chain runs on lane 0
// through w.each; a probe whose lanes never touch each other's words runs
// its whole chain in one w.each; dynrow_chain (shfl), vec_chain with rollit
// (gather) and rmw_chain_same (sync) step the warp together.  The clocks
// are read around run() by the kernel, not here.

#pragma once

#include <stdint.h>

#include "decode_pipe.cuh"

#ifdef __CUDACC__
#define SNAPPY_NO_UNROLL _Pragma("unroll 1")
#else
#define SNAPPY_NO_UNROLL
#endif

namespace snappy_probe {

constexpr int kSM = 16384;       // chased table words (probe_scalar.py SM)
constexpr int kRow = 128;        // words per row
constexpr int kTab = 128 * kRow;  // a (128, 128) table
constexpr int kScr = 66 * kRow;  // one scratch ref: rows 0..65
constexpr int kTile = 8 * kRow;  // the (8, 128) output tile

SNAPPY_HD uint32_t lcg(uint32_t x) { return x * 1103515245u + 12345u; }

// Word k (0..7) of a lane's share of the row pair at row x: row x + k / 4,
// column col + 32 * (k % 4), where col is the lane (or, in rmw_chain_same,
// the lane rotated by the step).
SNAPPY_HD int pair_at(int x, int col, int k) { return (x + (k >> 2)) * kRow + col + 32 * (k & 3); }

template <int U>
struct SmemChase {  // smem_chase (U = 1), smem_unroll(U)
  static constexpr int kStage = kSM, kZero = 0;
  static constexpr bool kScalar = true;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t*, int32_t* s, int n, int32_t* tile) {
    w.each([&](int l) {
      if (l != 0) return;
      int32_t x = 0;
      SNAPPY_NO_UNROLL
      for (int i = 0; i < n / U; ++i) {
        SNAPPY_UNROLL
        for (int k = 0; k < U; ++k) x = s[x];
      }
      tile[0] = x;
    });
  }
};

struct VmemScalar {
  static constexpr int kStage = 0, kZero = 0;
  static constexpr bool kScalar = true;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t* in, int32_t*, int n, int32_t* tile) {
    w.each([&](int l) {
      if (l != 0) return;
      int32_t x = 0;
      SNAPPY_NO_UNROLL
      for (int i = 0; i < n; ++i) x = in[x];
      tile[0] = x;
    });
  }
};

template <int U>
struct WhileUnroll {
  static constexpr int kStage = kSM, kZero = 0;
  static constexpr bool kScalar = true;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t*, int32_t* s, int n, int32_t* tile) {
    w.each([&](int l) {
      if (l != 0) return;
      int32_t x = 0;
      int i = 0;
      SNAPPY_NO_UNROLL
      while (i < n / U && x >= 0) {
        SNAPPY_UNROLL
        for (int k = 0; k < U; ++k) x = s[x];
        ++i;
      }
      tile[0] = x;
    });
  }
};

template <int PAR>
struct AluChain {  // seeds in[0..PAR)
  static constexpr int kStage = 0, kZero = 0;
  static constexpr bool kScalar = true;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t* in, int32_t*, int n, int32_t* tile) {
    w.each([&](int l) {
      if (l != 0) return;
      uint32_t xs[PAR];
      SNAPPY_UNROLL
      for (int j = 0; j < PAR; ++j) xs[j] = static_cast<uint32_t>(in[j]);
      SNAPPY_NO_UNROLL
      for (int i = 0; i < n; ++i) {
        SNAPPY_UNROLL
        for (int j = 0; j < PAR; ++j) xs[j] = lcg(xs[j]) & 0x7FFFFFFFu;
      }
      uint32_t sum = 0;
      SNAPPY_UNROLL
      for (int j = 0; j < PAR; ++j) sum += xs[j];
      tile[0] = static_cast<int32_t>(sum);
    });
  }
};

template <int U>
struct AluUnroll {
  static constexpr int kStage = 0, kZero = 0;
  static constexpr bool kScalar = true;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t* in, int32_t*, int n, int32_t* tile) {
    w.each([&](int l) {
      if (l != 0) return;
      uint32_t x = static_cast<uint32_t>(in[0]);
      SNAPPY_NO_UNROLL
      for (int i = 0; i < n / U; ++i) {
        SNAPPY_UNROLL
        for (int k = 0; k < U; ++k) x = lcg(x) & 0x7FFFFFFFu;
      }
      tile[0] = static_cast<int32_t>(x);
    });
  }
};

template <int PAR>
struct SmemPar {
  static constexpr int kStage = kSM, kZero = 0;
  static constexpr bool kScalar = true;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t*, int32_t* s, int n, int32_t* tile) {
    w.each([&](int l) {
      if (l != 0) return;
      int32_t xs[PAR];
      SNAPPY_UNROLL
      for (int j = 0; j < PAR; ++j) xs[j] = 17 * j;
      SNAPPY_NO_UNROLL
      for (int i = 0; i < n; ++i) {
        SNAPPY_UNROLL
        for (int j = 0; j < PAR; ++j) xs[j] = s[xs[j]];
      }
      uint32_t sum = 0;
      SNAPPY_UNROLL
      for (int j = 0; j < PAR; ++j) sum += static_cast<uint32_t>(xs[j]);
      tile[0] = static_cast<int32_t>(sum);
    });
  }
};

template <int PAR, int NS>
struct BigState {
  static constexpr int kStage = kSM, kZero = 0;
  static constexpr bool kScalar = true;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t*, int32_t* s, int n, int32_t* tile) {
    w.each([&](int l) {
      if (l != 0) return;
      uint32_t st[PAR][NS];
      SNAPPY_UNROLL
      for (int j = 0; j < PAR; ++j) {
        SNAPPY_UNROLL
        for (int k = 0; k < NS; ++k) st[j][k] = j * NS + k;
      }
      SNAPPY_NO_UNROLL
      for (int i = 0; i < n; ++i) {
        SNAPPY_UNROLL
        for (int j = 0; j < PAR; ++j) {
          st[j][0] = static_cast<uint32_t>(s[st[j][0]]);
          SNAPPY_UNROLL
          for (int k = 1; k < NS; ++k) st[j][k] = (st[j][k] * 29u + st[j][k - 1] + k) & 0x3FFFu;
        }
      }
      uint32_t sum = 0;
      SNAPPY_UNROLL
      for (int j = 0; j < PAR; ++j) {
        SNAPPY_UNROLL
        for (int k = 0; k < NS; ++k) sum += st[j][k];
      }
      tile[0] = static_cast<int32_t>(sum);
    });
  }
};

struct DynrowChain {  // n / 10 steps: x = tab[x][0] & 63, the whole pair read
  static constexpr int kStage = kTab, kZero = 0;
  static constexpr bool kScalar = true;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t*, int32_t* s, int n, int32_t* tile) {
    const volatile int32_t* v = s;
    typename W::template Var<int32_t> first;
    int x = 0;
    SNAPPY_NO_UNROLL
    for (int i = 0; i < n / 10; ++i) {
      w.each([&](int l) {
        int32_t p[8];
        SNAPPY_UNROLL
        for (int k = 0; k < 8; ++k) p[k] = v[pair_at(x, l, k)];
        first[l] = p[0];
      });
      x = w.shfl(first, 0) & 63;
    }
    w.each([&](int l) {
      if (l == 0) tile[0] = x;
    });
  }
};

template <int U>
struct DynrowNoextract {
  static constexpr int kStage = kTab, kZero = 0;
  static constexpr bool kScalar = false;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t*, int32_t* s, int n, int32_t* tile) {
    w.each([&](int l) {
      uint32_t x = 0;
      int32_t acc[8] = {};
      SNAPPY_NO_UNROLL
      for (int i = 0; i < n / U; ++i) {
        SNAPPY_UNROLL
        for (int u = 0; u < U; ++u) {
          x = lcg(x) & 63u;
          SNAPPY_UNROLL
          for (int k = 0; k < 8; ++k) acc[k] ^= s[pair_at(x, l, k)];
        }
      }
      SNAPPY_UNROLL
      for (int k = 0; k < 8; ++k) tile[pair_at(0, l, k)] = static_cast<int32_t>(static_cast<uint32_t>(acc[k]) + x);
    });
  }
};

template <int U>
struct DynrowWrite {
  static constexpr int kStage = 0, kZero = kScr;
  static constexpr bool kScalar = false;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t* in, int32_t* scr, int n, int32_t* tile) {
    w.each([&](int l) {
      uint32_t x = static_cast<uint32_t>(in[0]);
      SNAPPY_NO_UNROLL
      for (int i = 0; i < n / U; ++i) {
        SNAPPY_UNROLL
        for (int u = 0; u < U; ++u) {
          x = lcg(x) & 63u;
          int32_t p[8];
          SNAPPY_UNROLL
          for (int k = 0; k < 8; ++k) p[k] = scr[pair_at(x, l, k)];
          SNAPPY_UNROLL
          for (int k = 0; k < 8; ++k) scr[pair_at(x, l, k)] = p[k] ^ static_cast<int32_t>(x);
        }
      }
      SNAPPY_UNROLL
      for (int k = 0; k < 8; ++k)
        tile[pair_at(0, l, k)] = static_cast<int32_t>(static_cast<uint32_t>(scr[pair_at(0, l, k)]) + x);
    });
  }
};

template <int PAR, bool SHARED>
struct DynrowPar {
  static constexpr int kStage = 0, kZero = (SHARED ? 1 : PAR) * kScr;
  static constexpr bool kScalar = false;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t*, int32_t* scr, int n, int32_t* tile) {
    w.each([&](int l) {
      uint32_t xs[PAR];
      int32_t acc[PAR][8] = {};
      SNAPPY_UNROLL
      for (int j = 0; j < PAR; ++j) xs[j] = j;
      SNAPPY_NO_UNROLL
      for (int i = 0; i < n; ++i) {
        SNAPPY_UNROLL
        for (int j = 0; j < PAR; ++j) {
          const int32_t* ref = scr + (SHARED ? 0 : j * kScr);
          xs[j] = (lcg(xs[j]) + j) & 63u;
          SNAPPY_UNROLL
          for (int k = 0; k < 8; ++k) acc[j][k] ^= ref[pair_at(xs[j], l, k)];
        }
      }
      SNAPPY_UNROLL
      for (int k = 0; k < 8; ++k) {
        int32_t a = acc[0][k];
        SNAPPY_UNROLL
        for (int j = 1; j < PAR; ++j) a ^= acc[j][k];
        tile[pair_at(0, l, k)] = static_cast<int32_t>(static_cast<uint32_t>(a) + xs[0]);
      }
    });
  }
};

template <int PAR, bool SHARED>
struct DynrmwPar {
  static constexpr int kStage = 0, kZero = (SHARED ? 1 : PAR) * kScr;
  static constexpr bool kScalar = false;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t*, int32_t* scr, int n, int32_t* tile) {
    w.each([&](int l) {
      uint32_t xs[PAR];
      SNAPPY_UNROLL
      for (int j = 0; j < PAR; ++j) xs[j] = j;
      SNAPPY_NO_UNROLL
      for (int i = 0; i < n; ++i) {
        SNAPPY_UNROLL
        for (int j = 0; j < PAR; ++j) {
          int32_t* ref = scr + (SHARED ? 0 : j * kScr);
          const uint32_t x = (lcg(xs[j]) + j) & 63u;
          xs[j] = x;
          int32_t p[8];
          SNAPPY_UNROLL
          for (int k = 0; k < 8; ++k) p[k] = ref[pair_at(x, l, k)];
          SNAPPY_UNROLL
          for (int k = 0; k < 8; ++k) ref[pair_at(x, l, k)] = p[k] ^ static_cast<int32_t>(x + j);
        }
      }
      SNAPPY_UNROLL
      for (int k = 0; k < 8; ++k)
        tile[pair_at(0, l, k)] = static_cast<int32_t>(static_cast<uint32_t>(scr[pair_at(0, l, k)]) + xs[0]);
    });
  }
};

template <int U, bool ROLL>
struct VecChain {  // the (8, 128) tile h, lane l's words h[4 r + c] = (r, l + 32 c)
  static constexpr int kStage = 0, kZero = 0;
  static constexpr bool kScalar = false;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t* in, int32_t*, int n, int32_t* tile) {
    using V = typename W::template Var<int32_t>;
    uint32_t x = static_cast<uint32_t>(in[0]);
    V h[32];
    w.each([&](int l) {
      SNAPPY_UNROLL
      for (int k = 0; k < 32; ++k) h[k][l] = 0;
    });
    SNAPPY_NO_UNROLL
    for (int i = 0; i < n / U; ++i) {
      SNAPPY_UNROLL
      for (int u = 0; u < U; ++u) {
        x = lcg(x) & 31u;
        if (ROLL) {  // h = roll(h, x, axis=1) + 1: new[c] = old[(c - x) mod 128]
          V from;
          w.each([&](int l) { from[l] = (l - static_cast<int>(x)) & 31; });
          SNAPPY_UNROLL
          for (int r = 0; r < 8; ++r) {
            V v[4];
            SNAPPY_UNROLL
            for (int c = 0; c < 4; ++c) v[c] = w.gather(h[4 * r + c], from);
            w.each([&](int l) {
              const bool wrap = l < static_cast<int>(x);
              SNAPPY_UNROLL
              for (int c = 0; c < 4; ++c)
                h[4 * r + c][l] = static_cast<int32_t>(static_cast<uint32_t>(wrap ? v[(c + 3) & 3][l] : v[c][l]) + 1u);
            });
          }
        } else {
          w.each([&](int l) {
            SNAPPY_UNROLL
            for (int k = 0; k < 32; ++k) {
              const uint32_t y = static_cast<uint32_t>(h[k][l]);
              h[k][l] = static_cast<int32_t>((y ^ (y + x)) | 1u);
            }
          });
        }
      }
    }
    w.each([&](int l) {
      SNAPPY_UNROLL
      for (int k = 0; k < 32; ++k)
        tile[(k >> 2) * kRow + l + 32 * (k & 3)] = static_cast<int32_t>(static_cast<uint32_t>(h[k][l]) + x);
    });
  }
};

template <int U>
struct SplitRef {  // read from one scratch, write to another, lane-owned columns
  static constexpr int kStage = 0, kZero = 2 * kScr;
  static constexpr bool kScalar = false;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t* in, int32_t* scr, int n, int32_t* tile) {
    w.each([&](int l) {
      const int32_t* src = scr;
      int32_t* dst = scr + kScr;
      uint32_t x = static_cast<uint32_t>(in[0]);
      SNAPPY_NO_UNROLL
      for (int i = 0; i < n / U; ++i) {
        SNAPPY_UNROLL
        for (int u = 0; u < U; ++u) {
          x = lcg(x) & 63u;
          const uint32_t y = (x * 7u) & 63u;
          int32_t p[8];
          SNAPPY_UNROLL
          for (int k = 0; k < 8; ++k) p[k] = src[pair_at(x, l, k)];
          SNAPPY_UNROLL
          for (int k = 0; k < 8; ++k) dst[pair_at(y, l, k)] = static_cast<int32_t>(static_cast<uint32_t>(p[k]) + x);
        }
      }
      SNAPPY_UNROLL
      for (int k = 0; k < 8; ++k)
        tile[pair_at(0, l, k)] = static_cast<int32_t>(static_cast<uint32_t>(dst[pair_at(0, l, k)]) + x);
    });
  }
};

template <int U>
struct RmwSame {  // read row pair x, write row pair 7x & 63 of the same scratch; columns rotated by x & 31
  static constexpr int kStage = 0, kZero = kScr;
  static constexpr bool kScalar = false;
  template <class W>
  SNAPPY_HD static void run(W& w, const int32_t* in, int32_t* scr, int n, int32_t* tile) {
    uint32_t x = static_cast<uint32_t>(in[0]);
    SNAPPY_NO_UNROLL
    for (int i = 0; i < n / U; ++i) {
      SNAPPY_UNROLL
      for (int u = 0; u < U; ++u) {
        x = lcg(x) & 63u;
        const uint32_t y = (x * 7u) & 63u;
        const int r = static_cast<int>(x & 31u);
        w.sync();  // the group close: the last step's words, written by other lanes, are visible
        w.each([&](int l) {
          const int col = (l + r) & 31;
          int32_t p[8];
          SNAPPY_UNROLL
          for (int k = 0; k < 8; ++k) p[k] = scr[pair_at(x, col, k)];
          SNAPPY_UNROLL
          for (int k = 0; k < 8; ++k) scr[pair_at(y, col, k)] = p[k] ^ static_cast<int32_t>(x);
        });
      }
    }
    w.sync();
    w.each([&](int l) {
      SNAPPY_UNROLL
      for (int k = 0; k < 8; ++k)
        tile[pair_at(0, l, k)] = static_cast<int32_t>(static_cast<uint32_t>(scr[pair_at(0, l, k)]) + x);
    });
  }
};

}  // namespace snappy_probe

// Every shape the probes are built for, X(kind, a, b, P...): kind is the
// probe's index in tools/probe_scalar.py KINDS, a and b its parameters
// (u, par, ns, shared, rollit), P its body (X takes it as __VA_ARGS__: a
// template argument list holds commas).  The unroll factors are the TPU
// tool's sweeps: 1-32 for the scalar chains, 2, 8 and 16 for the row chains.
#define SNAPPY_PROBE_U6(X, kind, P) \
  X(kind, 1, 0, P<1>) X(kind, 2, 0, P<2>) X(kind, 4, 0, P<4>) X(kind, 8, 0, P<8>) X(kind, 16, 0, P<16>) X(kind, 32, 0, P<32>)
#define SNAPPY_PROBE_U3(X, kind, P) X(kind, 2, 0, P<2>) X(kind, 8, 0, P<8>) X(kind, 16, 0, P<16>)
#define SNAPPY_PROBE_PAR(X, kind, P) X(kind, 1, 0, P<1>) X(kind, 2, 0, P<2>) X(kind, 4, 0, P<4>) X(kind, 6, 0, P<6>)
#define SNAPPY_PROBE_PAR_SHARED(X, kind, P)                                                                   \
  X(kind, 1, 0, P<1, false>) X(kind, 1, 1, P<1, true>) X(kind, 2, 0, P<2, false>) X(kind, 2, 1, P<2, true>) \
  X(kind, 4, 0, P<4, false>) X(kind, 4, 1, P<4, true>) X(kind, 6, 0, P<6, false>) X(kind, 6, 1, P<6, true>)
#define SNAPPY_PROBE_SHAPES(X)                                                                               \
  X(0, 0, 0, snappy_probe::SmemChase<1>)                                                                     \
  X(1, 0, 0, snappy_probe::VmemScalar)                                                                       \
  X(2, 0, 0, snappy_probe::DynrowChain)                                                                      \
  SNAPPY_PROBE_PAR(X, 3, snappy_probe::AluChain)                                                             \
  SNAPPY_PROBE_U6(X, 4, snappy_probe::AluUnroll)                                                             \
  SNAPPY_PROBE_U6(X, 5, snappy_probe::SmemChase)                                                             \
  SNAPPY_PROBE_U6(X, 6, snappy_probe::WhileUnroll)                                                           \
  SNAPPY_PROBE_U3(X, 7, snappy_probe::DynrowNoextract)                                                       \
  SNAPPY_PROBE_U3(X, 8, snappy_probe::DynrowWrite)                                                           \
  SNAPPY_PROBE_PAR(X, 9, snappy_probe::SmemPar)                                                              \
  SNAPPY_PROBE_PAR_SHARED(X, 10, snappy_probe::DynrowPar)                                                    \
  SNAPPY_PROBE_PAR_SHARED(X, 11, snappy_probe::DynrmwPar)                                                    \
  X(12, 1, 7, snappy_probe::BigState<1, 7>) X(12, 1, 14, snappy_probe::BigState<1, 14>)                      \
  X(12, 6, 7, snappy_probe::BigState<6, 7>) X(12, 6, 14, snappy_probe::BigState<6, 14>)                      \
  X(13, 2, 0, snappy_probe::VecChain<2, false>) X(13, 2, 1, snappy_probe::VecChain<2, true>)                 \
  X(13, 8, 0, snappy_probe::VecChain<8, false>) X(13, 8, 1, snappy_probe::VecChain<8, true>)                 \
  SNAPPY_PROBE_U3(X, 14, snappy_probe::SplitRef)                                                             \
  SNAPPY_PROBE_U3(X, 15, snappy_probe::RmwSame)
