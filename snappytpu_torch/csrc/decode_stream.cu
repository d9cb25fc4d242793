// K4: the windowed stream decoder.
//
// Replaces the TPU kernel snappytpu/kernels/decode_vm2.py `decode_stream_vm`
// (`_stream_kernel` over `_block_loop`): N op chunks, cut at op boundaries,
// are decoded in order; chunk i's copies may reach ctx_lens[i] bytes before
// its own output, into the chunks before it or the caller's 64 KiB ctx0.
// Each chunk is parsed, validated and moved by the same decode loop as K2
// (decode_block.cuh, with ctx_len > 0), so K2, K3 and K4 share one accept set.
//
// What bounds it on the H100: one serial chain per call.  The chunks depend
// on each other through the window, so one thread block (one SM) walks all N
// chunks, and inside a chunk every op waits for the previous op's header.
// The card's other SMs idle; the kernel is latency-bound by design, and its
// time grows with the stream's op count, not its bytes.
//
// Design: the loop inside the block takes the place of the TPU's sequential
// grid.  Dynamic shared memory holds the chunk's 73728-byte compressed row and
// a 131072-byte ring (204800 B of the 227 KB a block may use).  The ring holds
// the 64 KiB of context before the chunk and the chunk's own output; all
// reads and writes address it modulo 131072.  A copy reaches at most
// opc + ctx_len <= opc + 65536 bytes back, so it never meets a slot that the
// current chunk has overwritten, and sliding the window is only advancing
// the chunk's start by out_len: the TPU kernel's byte-granular slide (an
// overlapping memmove) is gone.  Before a chunk, the free half of the ring
// is zeroed, so the context after a chunk equals the TPU kernel's even when
// the chunk was malformed.  After the chunk its row (zeros past out_len) is
// written out with 16-byte stores.  As in the TPU kernel, the window slides
// by out_len whenever 0 < out_len <= 65536, ok or not.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_block.cuh"

namespace {

using snappy_block::kBlockSize;
using snappy_block::kPadOut;

constexpr int kThreads = 256;
constexpr int64_t kRing = 2 * kBlockSize;
constexpr int64_t kRingMask = kRing - 1;
constexpr size_t kSmemBytes = kPadOut + kRing;  // comp row + ring

// Moves one op's bytes with the 32 lanes of a warp, addressing the ring from
// the chunk's start `base`.  __host__ __device__ only so that the shared
// decode loop instantiates; the host side is never called.
struct RingMover {
  const uint8_t* comp;
  uint8_t* ring;
  int64_t base;
  int lane;

  __host__ __device__ void literal(int64_t opc, int64_t src, int64_t len) {
#ifdef __CUDA_ARCH__
    for (int64_t j = lane; j < len; j += 32) ring[(base + opc + j) & kRingMask] = comp[src + j];
    __syncwarp();
#endif
  }

  __host__ __device__ void copy(int64_t opc, int64_t dist, int64_t len) {
#ifdef __CUDA_ARCH__
    const int64_t from = base + opc - dist;
    if (dist >= len) {
      for (int64_t j = lane; j < len; j += 32)
        ring[(base + opc + j) & kRingMask] = ring[(from + j) & kRingMask];
    } else {
      const int d = static_cast<int>(dist);
      for (int j = lane; j < len; j += 32)
        ring[(base + opc + j) & kRingMask] = ring[(from + j % d) & kRingMask];
    }
    __syncwarp();
#endif
  }
};

__global__ void __launch_bounds__(kThreads)
decode_stream_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_lens,
                     const int32_t* __restrict__ out_lens, const int32_t* __restrict__ ctx_lens,
                     const uint8_t* __restrict__ ctx0, uint8_t* __restrict__ out,
                     uint8_t* __restrict__ ok, int N) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ok_s;
  uint8_t* comp_s = smem;
  uint8_t* ring = smem + kPadOut;
  uint4* cs = reinterpret_cast<uint4*>(comp_s);

  // ctx0 fills ring [0, 65536); chunk 0 starts at 65536
  const uint4* c0 = reinterpret_cast<const uint4*>(ctx0);
  uint4* rs = reinterpret_cast<uint4*>(ring);
  for (int i = threadIdx.x; i < kBlockSize / 16; i += blockDim.x) rs[i] = c0[i];
  int64_t base = kBlockSize;

  for (int c = 0; c < N; ++c) {
    const uint4* src = reinterpret_cast<const uint4*>(comp + static_cast<size_t>(c) * kPadOut);
    for (int i = threadIdx.x; i < kPadOut / 16; i += blockDim.x) cs[i] = src[i];
    for (int j = threadIdx.x; j < kBlockSize; j += blockDim.x) ring[(base + j) & kRingMask] = 0;
    __syncthreads();

    const int64_t out_len = out_lens[c];
    if (threadIdx.x < 32) {
      // clamped so that a copy never reaches past the context the ring holds
      const int64_t want = ctx_lens[c];
      const int64_t ctx_len = want < 0 ? 0 : (want > kBlockSize ? kBlockSize : want);
      RingMover mv{comp_s, ring, base, static_cast<int>(threadIdx.x)};
      const bool good = snappy_block::decode_block(comp_s, comp_lens[c], out_len, ctx_len, mv);
      if (threadIdx.x == 0) ok_s = good;
    }
    __syncthreads();

    uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(c) * kBlockSize);
    for (int i = threadIdx.x; i < kBlockSize / 16; i += blockDim.x) {
      uint32_t w[4];
      for (int k = 0; k < 4; ++k) {
        const int64_t at = base + 16 * i + 4 * k;
        w[k] = ring[at & kRingMask] | (ring[(at + 1) & kRingMask] << 8) |
               (ring[(at + 2) & kRingMask] << 16) | (static_cast<uint32_t>(ring[(at + 3) & kRingMask]) << 24);
      }
      dst[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    if (threadIdx.x == 0) ok[c] = ok_s ? 1 : 0;
    if (out_len > 0 && out_len <= kBlockSize) base += out_len;
    __syncthreads();  // the next chunk overwrites the comp row and the ring
  }
}

}  // namespace

extern "C" int snappy_decode_stream(const void* comp, const void* comp_lens, const void* out_lens,
                                    const void* ctx_lens, const void* ctx0, void* out, void* ok, int N,
                                    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_stream_kernel<<<1, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_lens),
      static_cast<const int32_t*>(out_lens), static_cast<const int32_t*>(ctx_lens),
      static_cast<const uint8_t*>(ctx0), static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok), N);
  return static_cast<int>(cudaGetLastError());
}
