// K1: variable-length row concatenation, the encoder's last step.
//
// Replaces the TPU kernel snappytpu/kernels/concat.py `_concat_kernel`
// (entry `concat_rows_words`, called by encode_v2._emit).  Per row b it
// writes the first lens[b, s] bytes of each of the S sections back to back
// and zero-fills the rest of the row up to out_cap (the rules, clamps and
// reads are in concat.cuh).
//
// What bounds it on the H100: bytes moved.  A main-path batch reads up to
// 128 x 64 x 1536 B of sections and writes 128 x 73728 B of rows (~14 MB for
// the encoder's lengths) with no arithmetic to speak of.  The TPU version
// needed funnel shifts over packed int32 words and 504-byte masked merges
// because the TPU has no byte loads or scalar stores.
//
// Design for that bound: the grid is (row, output tile of kTile bytes), 128
// rows x 36 tiles of 2 KiB at the main path's shape, and a block holds 32
// registers a thread, so 16 blocks (2048 threads) are in flight on every SM
// to hide the memory latency.  Each thread owns one 16-byte window of its
// tile and writes it with one aligned 16-byte store, zeros included: every
// byte of the row is written once, by its owner, with no memset and no
// second pass.  Its sources come as aligned 16-byte read-only loads, shifted
// into place in registers.  A window waits on one round trip to memory
// however many sections it spans: the words of its first two sections, and
// in a tile where a window spans three or more, the first words of the
// sections that start in the tile (staged into shared memory), are all
// loaded before any is used, and a window's end takes constant time.
// Loading a later section's words when the one before is placed would
// chain a round trip per section, and walking them one by one would chain a
// search per section; one window of 16 one-byte sections would then set the
// kernel's time.  Each block re-takes the row's 64-length scan (256 B from
// L2 after the row's first block) rather than wait on another block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "concat.cuh"

namespace {

using snappy_concat::kThreads;
using snappy_concat::Word;

// concat.cuh's warp policy on the device: one lane per thread.  Its methods,
// and the load's, are __host__ __device__ only so that concat.cuh's
// __host__ __device__ templates instantiate; the host side is never called.
struct LaneWarp {
  template <class T>
  struct Var {
    T v;
    __host__ __device__ T& operator[](int) { return v; }
    __host__ __device__ const T& operator[](int) const { return v; }
  };
  int lane;
  template <class F>
  __host__ __device__ void each(F f) { f(lane); }
  __host__ __device__ void excl_scan(Var<int32_t>& x) const {
#ifdef __CUDA_ARCH__
    int32_t s = x.v;
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += y;
    }
    x.v = s - x.v;
#endif
  }
  __host__ __device__ int32_t shfl(const Var<int32_t>& x, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xFFFFFFFFu, x.v, src);
#else
    (void)src;
    return x.v;
#endif
  }
};

// Word k of section s of one row, by a read-only 16-byte load.
struct SectionLoad {
  const uint8_t* row;
  int32_t cap;
  __host__ __device__ Word operator()(int32_t s, int32_t k) const {
#ifdef __CUDA_ARCH__
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + static_cast<size_t>(s) * cap) + k);
    return Word{{u.x, u.y, u.z, u.w}};
#else
    (void)s;
    (void)k;
    return Word{{0u, 0u, 0u, 0u}};
#endif
  }
};

__global__ void __launch_bounds__(kThreads, 16)  // 32 registers: 16 blocks, 2048 threads an SM
concat_rows_kernel(const uint8_t* __restrict__ pieces, const int32_t* __restrict__ lens,
                   uint8_t* __restrict__ out, int S, int cap, int out_cap) {
  __shared__ uint32_t stage[snappy_concat::kTile / 4];  // the tile, where a window holds 3+ sections
  extern __shared__ int32_t off_s[];  // S + 2: the offsets, the row's total, its sections of 1-14 bytes
  const int b = blockIdx.x;
  if (threadIdx.x < 32) {
    LaneWarp w{static_cast<int>(threadIdx.x)};
    snappy_concat::scan_lengths(w, lens + static_cast<size_t>(b) * S, S, cap, off_s);
  }
  __syncthreads();
  const int32_t p = snappy_concat::window_start(blockIdx.y, threadIdx.x);
  const SectionLoad load{pieces + static_cast<size_t>(b) * S * cap, cap};
  const snappy_concat::Window win = snappy_concat::begin_window(load, off_s, S, out_cap, p);
  // where a window of the tile holds three sections or more (only in a row
  // with a section of 1-14 bytes), the tile is staged
  if (off_s[S + 1] > 0 && __syncthreads_or(win.more)) {
    const snappy_concat::TileSections ts = snappy_concat::tile_sections(off_s, S, out_cap, blockIdx.y);
    snappy_concat::stage_sections(load, off_s, S, ts, threadIdx.x, reinterpret_cast<uint8_t*>(stage));
    __syncthreads();
  }
  if (p < out_cap) {  // the last tile may pass the row
    const Word v = snappy_concat::end_window(win, stage, blockIdx.y * snappy_concat::kTile, p);
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * out_cap + p) = make_uint4(v.x[0], v.x[1], v.x[2], v.x[3]);
  }
}

}  // namespace

extern "C" int snappy_concat_rows(const void* pieces, const void* lens, void* out, int B, int S,
                                  int cap, int out_cap, void* stream) {
  const size_t smem = (static_cast<size_t>(S) + 2) * sizeof(int32_t);
  const dim3 grid(B, (out_cap + snappy_concat::kTile - 1) / snappy_concat::kTile);
  concat_rows_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pieces), static_cast<const int32_t*>(lens),
      static_cast<uint8_t*>(out), S, cap, out_cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* snappy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
