// T1: the scalar-chain probes — the primitives a decoder's serial chain is
// made of, timed one dependent chain at a time.
//
// Replaces the 16 TPU kernels of tools/probe_scalar.py (the `run` closures of
// smem_chase, vmem_scalar, dynrow_chain, alu_chain, alu_unroll, smem_unroll,
// while_unroll, dynrow_noextract, dynrow_write, smem_par, dynrow_par,
// dynrmw_par, bigstate_par, vec_chain, split_ref_chain and rmw_chain_same).
// Each runs one chain of n steps inside one thread block of one warp and
// returns the chain's final value in an (8, 128) int32 tile laid out as the
// TPU kernel's; the plain versions in snappytpu_torch/tools/probe_scalar.py
// compute the same tiles.  How each TPU primitive maps onto Hopper:
//   * SMEM scalar loads (x = smem[x]) -> one thread chasing through shared
//     memory (smem_chase, smem_unroll, smem_par, while_unroll with its
//     data-dependent exit, bigstate_par's chase);
//   * scalar reads of VMEM -> one thread chasing through global memory
//     (vmem_scalar; the 64 KiB table stays in L1/L2 after the first pass);
//   * (2, 128) dynamic row reads and writes of a (128, 128) int32 VMEM ref ->
//     the warp reading or writing a dynamic pair of 512-byte shared-memory
//     rows, lane l owning words l, l + 32, l + 64, l + 96 of each row
//     (coalesced, no bank conflicts).  Lane l touches only its own columns,
//     so a row read-modify-write chain needs no __syncwarp.  The next row
//     index comes from the scalar chain, which every lane computes, except
//     in dynrow_chain, where it is lane 0's word taken by __shfl_sync (the
//     TPU kernel's vector-to-scalar extraction); there the row's other words
//     are read through a volatile pointer, so that the whole row is loaded;
//   * pltpu.roll along the 128 lanes -> a __shfl_sync rotate of the (8, 128)
//     tile held in registers, 32 words per lane (vec_chain with rollit);
//   * scalar and vector ALU chains -> the same arithmetic in 32-bit unsigned
//     registers (int32 wrap-around, as the TPU's).
// Scratch refs the TPU kernels never initialise (dynrow_write, dynrow_par,
// dynrmw_par, split_ref_chain, rmw_chain_same) are zeroed here first; a
// `& 63` row chain touches rows 0-64, so each scratch holds 66 rows, and six
// of them fit in shared memory (202,752 bytes) where six (128, 128) refs
// would not.
//
// Timing: clock64() and %globaltimer are read by every lane around the chain
// after a __syncwarp and again after the chain's result is stored and the
// warp synchronised; lane 0 writes {cycles, ns}.  What bounds each probe is
// the latency of one step of its chain: that is what it measures.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSM = 16384;            // chased table words (probe_scalar.py SM)
constexpr int kRow = 128;             // words per row
constexpr int kTab = 128 * kRow;      // a (128, 128) table
constexpr int kScr = 66 * kRow;       // one scratch ref: rows 0..65
constexpr int kTile = 8 * kRow;       // the (8, 128) output tile

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t lcg(uint32_t x) { return x * 1103515245u + 12345u; }

// Word k (0..7) of this lane's share of the row pair at row x: row x + k / 4,
// column lane + 32 * (k % 4).
__device__ __forceinline__ int pair_at(int x, int lane, int k) { return (x + (k >> 2)) * kRow + lane + 32 * (k & 3); }

// ---- probes: kStage input words staged to shared memory, then kZero zeroed
// scratch words; run() leaves the result in tile (kScalar: tile[0] only) ----

template <int U>
struct SmemChase {  // smem_chase (U = 1), smem_unroll(U)
  static constexpr int kStage = kSM, kZero = 0;
  static constexpr bool kScalar = true;
  __device__ static void run(const int32_t*, int32_t* s, int n, int lane, int32_t* tile) {
    if (lane != 0) return;
    int32_t x = 0;
#pragma unroll 1
    for (int i = 0; i < n / U; ++i) {
#pragma unroll
      for (int k = 0; k < U; ++k) x = s[x];
    }
    tile[0] = x;
  }
};

struct VmemScalar {
  static constexpr int kStage = 0, kZero = 0;
  static constexpr bool kScalar = true;
  __device__ static void run(const int32_t* in, int32_t*, int n, int lane, int32_t* tile) {
    if (lane != 0) return;
    int32_t x = 0;
#pragma unroll 1
    for (int i = 0; i < n; ++i) x = in[x];
    tile[0] = x;
  }
};

template <int U>
struct WhileUnroll {
  static constexpr int kStage = kSM, kZero = 0;
  static constexpr bool kScalar = true;
  __device__ static void run(const int32_t*, int32_t* s, int n, int lane, int32_t* tile) {
    if (lane != 0) return;
    int32_t x = 0;
    int i = 0;
#pragma unroll 1
    while (i < n / U && x >= 0) {
#pragma unroll
      for (int k = 0; k < U; ++k) x = s[x];
      ++i;
    }
    tile[0] = x;
  }
};

template <int PAR>
struct AluChain {  // seeds in[0..PAR)
  static constexpr int kStage = 0, kZero = 0;
  static constexpr bool kScalar = true;
  __device__ static void run(const int32_t* in, int32_t*, int n, int lane, int32_t* tile) {
    if (lane != 0) return;
    uint32_t xs[PAR];
#pragma unroll
    for (int j = 0; j < PAR; ++j) xs[j] = static_cast<uint32_t>(in[j]);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < PAR; ++j) xs[j] = lcg(xs[j]) & 0x7FFFFFFFu;
    }
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < PAR; ++j) sum += xs[j];
    tile[0] = static_cast<int32_t>(sum);
  }
};

template <int U>
struct AluUnroll {
  static constexpr int kStage = 0, kZero = 0;
  static constexpr bool kScalar = true;
  __device__ static void run(const int32_t* in, int32_t*, int n, int lane, int32_t* tile) {
    if (lane != 0) return;
    uint32_t x = static_cast<uint32_t>(in[0]);
#pragma unroll 1
    for (int i = 0; i < n / U; ++i) {
#pragma unroll
      for (int k = 0; k < U; ++k) x = lcg(x) & 0x7FFFFFFFu;
    }
    tile[0] = static_cast<int32_t>(x);
  }
};

template <int PAR>
struct SmemPar {
  static constexpr int kStage = kSM, kZero = 0;
  static constexpr bool kScalar = true;
  __device__ static void run(const int32_t*, int32_t* s, int n, int lane, int32_t* tile) {
    if (lane != 0) return;
    int32_t xs[PAR];
#pragma unroll
    for (int j = 0; j < PAR; ++j) xs[j] = 17 * j;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < PAR; ++j) xs[j] = s[xs[j]];
    }
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < PAR; ++j) sum += static_cast<uint32_t>(xs[j]);
    tile[0] = static_cast<int32_t>(sum);
  }
};

template <int PAR, int NS>
struct BigState {
  static constexpr int kStage = kSM, kZero = 0;
  static constexpr bool kScalar = true;
  __device__ static void run(const int32_t*, int32_t* s, int n, int lane, int32_t* tile) {
    if (lane != 0) return;
    uint32_t st[PAR][NS];
#pragma unroll
    for (int j = 0; j < PAR; ++j)
#pragma unroll
      for (int k = 0; k < NS; ++k) st[j][k] = j * NS + k;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < PAR; ++j) {
        st[j][0] = static_cast<uint32_t>(s[st[j][0]]);
#pragma unroll
        for (int k = 1; k < NS; ++k) st[j][k] = (st[j][k] * 29u + st[j][k - 1] + k) & 0x3FFFu;
      }
    }
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < PAR; ++j)
#pragma unroll
      for (int k = 0; k < NS; ++k) sum += st[j][k];
    tile[0] = static_cast<int32_t>(sum);
  }
};

struct DynrowChain {  // n / 10 steps: x = tab[x][0] & 63, the whole pair read
  static constexpr int kStage = kTab, kZero = 0;
  static constexpr bool kScalar = true;
  __device__ static void run(const int32_t*, int32_t* s, int n, int lane, int32_t* tile) {
    const volatile int32_t* v = s;
    int x = 0;
#pragma unroll 1
    for (int i = 0; i < n / 10; ++i) {
      int32_t w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = v[pair_at(x, lane, k)];
      x = __shfl_sync(kFull, w[0], 0) & 63;
    }
    if (lane == 0) tile[0] = x;
  }
};

template <int U>
struct DynrowNoextract {
  static constexpr int kStage = kTab, kZero = 0;
  static constexpr bool kScalar = false;
  __device__ static void run(const int32_t*, int32_t* s, int n, int lane, int32_t* tile) {
    uint32_t x = 0;
    int32_t acc[8] = {};
#pragma unroll 1
    for (int i = 0; i < n / U; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x = lcg(x) & 63u;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] ^= s[pair_at(x, lane, k)];
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) tile[pair_at(0, lane, k)] = acc[k] + static_cast<int32_t>(x);
  }
};

template <int U>
struct DynrowWrite {
  static constexpr int kStage = 0, kZero = kScr;
  static constexpr bool kScalar = false;
  __device__ static void run(const int32_t* in, int32_t* scr, int n, int lane, int32_t* tile) {
    uint32_t x = static_cast<uint32_t>(in[0]);
#pragma unroll 1
    for (int i = 0; i < n / U; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x = lcg(x) & 63u;
        int32_t p[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k] = scr[pair_at(x, lane, k)];
#pragma unroll
        for (int k = 0; k < 8; ++k) scr[pair_at(x, lane, k)] = p[k] ^ static_cast<int32_t>(x);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) tile[pair_at(0, lane, k)] = scr[pair_at(0, lane, k)] + static_cast<int32_t>(x);
  }
};

template <int PAR, bool SHARED>
struct DynrowPar {
  static constexpr int kStage = 0, kZero = (SHARED ? 1 : PAR) * kScr;
  static constexpr bool kScalar = false;
  __device__ static void run(const int32_t*, int32_t* scr, int n, int lane, int32_t* tile) {
    uint32_t xs[PAR];
    int32_t acc[PAR][8] = {};
#pragma unroll
    for (int j = 0; j < PAR; ++j) xs[j] = j;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < PAR; ++j) {
        const int32_t* ref = scr + (SHARED ? 0 : j * kScr);
        xs[j] = (lcg(xs[j]) + j) & 63u;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] ^= ref[pair_at(xs[j], lane, k)];
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int32_t a = acc[0][k];
#pragma unroll
      for (int j = 1; j < PAR; ++j) a ^= acc[j][k];
      tile[pair_at(0, lane, k)] = a + static_cast<int32_t>(xs[0]);
    }
  }
};

template <int PAR, bool SHARED>
struct DynrmwPar {
  static constexpr int kStage = 0, kZero = (SHARED ? 1 : PAR) * kScr;
  static constexpr bool kScalar = false;
  __device__ static void run(const int32_t*, int32_t* scr, int n, int lane, int32_t* tile) {
    uint32_t xs[PAR];
#pragma unroll
    for (int j = 0; j < PAR; ++j) xs[j] = j;
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int j = 0; j < PAR; ++j) {
        int32_t* ref = scr + (SHARED ? 0 : j * kScr);
        const uint32_t x = (lcg(xs[j]) + j) & 63u;
        xs[j] = x;
        int32_t p[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k] = ref[pair_at(x, lane, k)];
#pragma unroll
        for (int k = 0; k < 8; ++k) ref[pair_at(x, lane, k)] = p[k] ^ static_cast<int32_t>(x + j);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) tile[pair_at(0, lane, k)] = scr[pair_at(0, lane, k)] + static_cast<int32_t>(xs[0]);
  }
};

template <int U, bool ROLL>
struct VecChain {  // the (8, 128) tile h, this lane's words h[4 r + c] = (r, lane + 32 c)
  static constexpr int kStage = 0, kZero = 0;
  static constexpr bool kScalar = false;
  __device__ static void run(const int32_t* in, int32_t*, int n, int lane, int32_t* tile) {
    uint32_t x = static_cast<uint32_t>(in[0]);
    uint32_t h[32] = {};
#pragma unroll 1
    for (int i = 0; i < n / U; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x = lcg(x) & 31u;
        if (ROLL) {  // h = roll(h, x, axis=1) + 1: new[c] = old[(c - x) mod 128]
          const int from = (lane - static_cast<int>(x)) & 31;
          const bool wrap = lane < static_cast<int>(x);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            uint32_t v[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) v[c] = __shfl_sync(kFull, h[4 * r + c], from);
#pragma unroll
            for (int c = 0; c < 4; ++c) h[4 * r + c] = (wrap ? v[(c + 3) & 3] : v[c]) + 1u;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 32; ++k) h[k] = (h[k] ^ (h[k] + x)) | 1u;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) tile[(k >> 2) * kRow + lane + 32 * (k & 3)] = static_cast<int32_t>(h[k] + x);
  }
};

template <int U>
struct SplitRef {  // read from one scratch, write to another
  static constexpr int kStage = 0, kZero = 2 * kScr;
  static constexpr bool kScalar = false;
  __device__ static void run(const int32_t* in, int32_t* scr, int n, int lane, int32_t* tile) {
    const int32_t* src = scr;
    int32_t* dst = scr + kScr;
    uint32_t x = static_cast<uint32_t>(in[0]);
#pragma unroll 1
    for (int i = 0; i < n / U; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x = lcg(x) & 63u;
        const uint32_t y = (x * 7u) & 63u;
        int32_t p[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k] = src[pair_at(x, lane, k)];
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[pair_at(y, lane, k)] = p[k] + static_cast<int32_t>(x);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) tile[pair_at(0, lane, k)] = dst[pair_at(0, lane, k)] + static_cast<int32_t>(x);
  }
};

template <int U>
struct RmwSame {  // read row pair x, write row pair 7x & 63 of the same scratch
  static constexpr int kStage = 0, kZero = kScr;
  static constexpr bool kScalar = false;
  __device__ static void run(const int32_t* in, int32_t* scr, int n, int lane, int32_t* tile) {
    uint32_t x = static_cast<uint32_t>(in[0]);
#pragma unroll 1
    for (int i = 0; i < n / U; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x = lcg(x) & 63u;
        const uint32_t y = (x * 7u) & 63u;
        int32_t p[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k] = scr[pair_at(x, lane, k)];
#pragma unroll
        for (int k = 0; k < 8; ++k) scr[pair_at(y, lane, k)] = p[k] ^ static_cast<int32_t>(x);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) tile[pair_at(0, lane, k)] = scr[pair_at(0, lane, k)] + static_cast<int32_t>(x);
  }
};

// ---- the kernel: one warp ----

template <class P>
__global__ void __launch_bounds__(32)
probe_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long* __restrict__ clk, int n) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int32_t tile[kTile];
  const int lane = static_cast<int>(threadIdx.x);
  for (int i = lane; i < P::kStage; i += 32) smem[i] = in[i];
  for (int i = lane; i < P::kZero; i += 32) smem[P::kStage + i] = 0;
  for (int i = lane; i < kTile; i += 32) tile[i] = 0;
  __syncwarp();
  const long long c0 = clock64();
  const long long t0 = global_ns();
  P::run(in, smem, n, lane, tile);
  __syncwarp();
  const long long c1 = clock64();
  const long long t1 = global_ns();
  if (lane == 0) {
    clk[0] = c1 - c0;
    clk[1] = t1 - t0;
  }
  for (int i = lane; i < kTile; i += 32) out[i] = P::kScalar ? tile[0] : tile[i];
}

template <class P>
int launch(const void* in, void* out, void* clk, int n, cudaStream_t stream) {
  const int bytes = (P::kStage + P::kZero) * static_cast<int>(sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(probe_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_kernel<P><<<1, 32, bytes, stream>>>(static_cast<const int32_t*>(in), static_cast<int32_t*>(out),
                                            static_cast<long long*>(clk), n);
  return static_cast<int>(cudaGetLastError());
}

#define SNAPPY_BAD static_cast<int>(cudaErrorInvalidValue)
#define SNAPPY_BY_U(P, u, ...)                                        \
  switch (u) {                                                        \
    case 1: return launch<P<1>>(__VA_ARGS__);                         \
    case 2: return launch<P<2>>(__VA_ARGS__);                         \
    case 4: return launch<P<4>>(__VA_ARGS__);                         \
    case 8: return launch<P<8>>(__VA_ARGS__);                         \
    case 16: return launch<P<16>>(__VA_ARGS__);                       \
    case 32: return launch<P<32>>(__VA_ARGS__);                       \
    default: return SNAPPY_BAD;                                       \
  }
#define SNAPPY_BY_U_ROW(P, u, ...)                                    \
  switch (u) {                                                        \
    case 2: return launch<P<2>>(__VA_ARGS__);                         \
    case 8: return launch<P<8>>(__VA_ARGS__);                         \
    case 16: return launch<P<16>>(__VA_ARGS__);                       \
    default: return SNAPPY_BAD;                                       \
  }
#define SNAPPY_BY_PAR(P, par, ...)                                    \
  switch (par) {                                                      \
    case 1: return launch<P<1>>(__VA_ARGS__);                         \
    case 2: return launch<P<2>>(__VA_ARGS__);                         \
    case 4: return launch<P<4>>(__VA_ARGS__);                         \
    case 6: return launch<P<6>>(__VA_ARGS__);                         \
    default: return SNAPPY_BAD;                                       \
  }
#define SNAPPY_BY_PAR_SHARED(P, par, shared, ...)                     \
  switch (par * 2 + (shared ? 1 : 0)) {                               \
    case 2: return launch<P<1, false>>(__VA_ARGS__);                  \
    case 3: return launch<P<1, true>>(__VA_ARGS__);                   \
    case 4: return launch<P<2, false>>(__VA_ARGS__);                  \
    case 5: return launch<P<2, true>>(__VA_ARGS__);                   \
    case 8: return launch<P<4, false>>(__VA_ARGS__);                  \
    case 9: return launch<P<4, true>>(__VA_ARGS__);                   \
    case 12: return launch<P<6, false>>(__VA_ARGS__);                 \
    case 13: return launch<P<6, true>>(__VA_ARGS__);                  \
    default: return SNAPPY_BAD;                                       \
  }

}  // namespace

// kind: the probe's index in tools/probe_scalar.py KINDS; a, b: its
// parameters (u, par, ns, shared, rollit).  The unroll factors are the TPU
// tool's sweeps: 1-32 for the scalar chains, 2, 8 and 16 for the row chains.  in: its table or seeds; out: the
// (8, 128) int32 tile; clk: {cycles, ns} of the chain; n: steps.
extern "C" int snappy_probe_scalar(int kind, int a, int b, const void* in, void* out, void* clk, int n,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch<SmemChase<1>>(in, out, clk, n, s);
    case 1: return launch<VmemScalar>(in, out, clk, n, s);
    case 2: return launch<DynrowChain>(in, out, clk, n, s);
    case 3: SNAPPY_BY_PAR(AluChain, a, in, out, clk, n, s)
    case 4: SNAPPY_BY_U(AluUnroll, a, in, out, clk, n, s)
    case 5: SNAPPY_BY_U(SmemChase, a, in, out, clk, n, s)
    case 6: SNAPPY_BY_U(WhileUnroll, a, in, out, clk, n, s)
    case 7: SNAPPY_BY_U_ROW(DynrowNoextract, a, in, out, clk, n, s)
    case 8: SNAPPY_BY_U_ROW(DynrowWrite, a, in, out, clk, n, s)
    case 9: SNAPPY_BY_PAR(SmemPar, a, in, out, clk, n, s)
    case 10: SNAPPY_BY_PAR_SHARED(DynrowPar, a, b, in, out, clk, n, s)
    case 11: SNAPPY_BY_PAR_SHARED(DynrmwPar, a, b, in, out, clk, n, s)
    case 12:
      if (a == 1 && b == 7) return launch<BigState<1, 7>>(in, out, clk, n, s);
      if (a == 1 && b == 14) return launch<BigState<1, 14>>(in, out, clk, n, s);
      if (a == 6 && b == 7) return launch<BigState<6, 7>>(in, out, clk, n, s);
      if (a == 6 && b == 14) return launch<BigState<6, 14>>(in, out, clk, n, s);
      return SNAPPY_BAD;
    case 13:
      if (a == 2) return b ? launch<VecChain<2, true>>(in, out, clk, n, s) : launch<VecChain<2, false>>(in, out, clk, n, s);
      if (a == 8) return b ? launch<VecChain<8, true>>(in, out, clk, n, s) : launch<VecChain<8, false>>(in, out, clk, n, s);
      return SNAPPY_BAD;
    case 14: SNAPPY_BY_U_ROW(SplitRef, a, in, out, clk, n, s)
    case 15: SNAPPY_BY_U_ROW(RmwSame, a, in, out, clk, n, s)
    default: return SNAPPY_BAD;
  }
}
