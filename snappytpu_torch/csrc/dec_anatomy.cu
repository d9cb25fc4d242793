// T2: the decode anatomy probe — the op-by-op walk (K3's kernel until K3
// moved onto the byte-source resolver) with its mover stripped.
//
// Replaces the TPU kernel of tools/dec_anatomy.py `decode` (the kernels of
// `make_decoder(variant)`), which times stripped variants of the v2 piece
// loop to split the block decoder's serial chain into parse, window read,
// merge and dynamic addressing.  Here every variant is that walk
// (snappy_block::decode_block in decode_block.cuh, one op at a time; K2
// pipelines the same rules in decode_pipe.cuh) with another mover.  The
// walk's trip depends only on the parse, never on moved bytes, so every
// variant runs the same ops and ends at the same output cursor:
//   parse   the mover moves nothing: the parse chain and the loop alone
//   window  the lanes read each op's source bytes (the literal's bytes in the
//           compressed row, or the copy's bytes `dist` back in the output
//           image, by the walk's index j or j % dist) and fold them into a
//           per-lane word; nothing is written, so the image stays zero and a
//           copy reads zeros.  window − parse is the reads and the
//           __syncwarp per op
//   full    the walk's mover exactly (snappy_block::WarpMover): the real decode.
//           full − window is the writes
//   fixed   full's reads and writes, every op at one fixed address: bytes
//           from compressed byte 64 on (j or j % dist), written to the
//           image from byte 0 on, and folded like window.  full − fixed is
//           the cost of addresses that move with the op
// Every mover records where the last op it was handed ends, which is the
// final output cursor (the TPU tool's ok tile holds the same `opc`).
//
// Outputs per block, all defined for every variant and computed exactly by
// the plain walk (snappytpu_torch/tools/dec_anatomy.py `anatomy_ref`): the
// output image after the walk (zero for parse and window, the decoded row for
// full, the fixed area's last bytes for fixed), K2's ok flag, the final
// cursor, and the fold: the XOR over the lanes of each byte read, shifted
// to byte lane (destination offset & 3), so that the fold is the XOR of the
// little-endian words the read bytes would form at their destinations (0
// for parse and full).  The TPU tool XORed its accumulator into every
// output row to keep the stripped dataflow alive; here the fold and the
// cursor are outputs in their own right.
//
// What bounds it on the H100: the serial op chain, one block per SM; the
// variants differ only in what each op's 32 lanes do.  Design: the walk's
// shape — one thread block of 256 threads per 64 KiB block, the 73,728-byte
// row and a zeroed 65,536-byte image in dynamic shared memory, warp 0 walks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_block.cuh"

namespace {

using snappy_block::kBlockSize;
using snappy_block::kPadOut;

constexpr int kThreads = 256;
constexpr size_t kSmemBytes = kPadOut + kBlockSize;  // comp row + output image
constexpr int kFixedSrc = 64;                        // fixed's source: compressed byte 64

__device__ __forceinline__ uint32_t lane_word(uint8_t v, int64_t dst) {
  return static_cast<uint32_t>(v) << (8 * (dst & 3));
}

struct ParseMover {
  const uint8_t* comp;
  uint8_t* out;
  int lane;
  int64_t end = 0;
  uint32_t acc = 0;

  __host__ __device__ void literal(int64_t opc, int64_t, int64_t len) { end = opc + len; }
  __host__ __device__ void copy(int64_t opc, int64_t, int64_t len) { end = opc + len; }
};

struct WindowMover {
  const uint8_t* comp;
  uint8_t* out;
  int lane;
  int64_t end = 0;
  uint32_t acc = 0;

  __host__ __device__ void literal(int64_t opc, int64_t src, int64_t len) {
#ifdef __CUDA_ARCH__
    for (int64_t j = lane; j < len; j += 32) acc ^= lane_word(comp[src + j], opc + j);
    __syncwarp();
#endif
    end = opc + len;
  }

  __host__ __device__ void copy(int64_t opc, int64_t dist, int64_t len) {
#ifdef __CUDA_ARCH__
    const uint8_t* from = out + opc - dist;
    if (dist >= len) {
      for (int64_t j = lane; j < len; j += 32) acc ^= lane_word(from[j], opc + j);
    } else {
      const int d = static_cast<int>(dist);
      for (int j = lane; j < len; j += 32) acc ^= lane_word(from[j % d], opc + j);
    }
    __syncwarp();
#endif
    end = opc + len;
  }
};

struct FullMover : snappy_block::WarpMover {
  int64_t end = 0;
  uint32_t acc = 0;

  __host__ __device__ void literal(int64_t opc, int64_t src, int64_t len) {
    WarpMover::literal(opc, src, len);
    end = opc + len;
  }
  __host__ __device__ void copy(int64_t opc, int64_t dist, int64_t len) {
    WarpMover::copy(opc, dist, len);
    end = opc + len;
  }
};

// Every op's bytes from comp + kFixedSrc to out + 0: len <= out_len <= 65536,
// so the reads stay inside the 73,728-byte row and the writes inside the image.
struct FixedMover {
  const uint8_t* comp;
  uint8_t* out;
  int lane;
  int64_t end = 0;
  uint32_t acc = 0;

  __host__ __device__ void literal(int64_t opc, int64_t, int64_t len) {
#ifdef __CUDA_ARCH__
    const uint8_t* from = comp + kFixedSrc;
    for (int64_t j = lane; j < len; j += 32) {
      const uint8_t v = from[j];
      out[j] = v;
      acc ^= lane_word(v, j);
    }
    __syncwarp();
#endif
    end = opc + len;
  }

  __host__ __device__ void copy(int64_t opc, int64_t dist, int64_t len) {
#ifdef __CUDA_ARCH__
    const uint8_t* from = comp + kFixedSrc;
    if (dist >= len) {
      for (int64_t j = lane; j < len; j += 32) {
        const uint8_t v = from[j];
        out[j] = v;
        acc ^= lane_word(v, j);
      }
    } else {
      const int d = static_cast<int>(dist);
      for (int j = lane; j < len; j += 32) {
        const uint8_t v = from[j % d];
        out[j] = v;
        acc ^= lane_word(v, j);
      }
    }
    __syncwarp();
#endif
    end = opc + len;
  }
};

template <class Mover>
__global__ void __launch_bounds__(kThreads)
anatomy_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_lens,
               const int32_t* __restrict__ out_lens, uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
               int32_t* __restrict__ opc, int32_t* __restrict__ fold) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ok_s;
  uint8_t* comp_s = smem;
  uint8_t* out_s = smem + kPadOut;
  const int b = blockIdx.x;

  const uint4* src = reinterpret_cast<const uint4*>(comp + static_cast<size_t>(b) * kPadOut);
  uint4* cs = reinterpret_cast<uint4*>(comp_s);
  uint4* os = reinterpret_cast<uint4*>(out_s);
  for (int i = threadIdx.x; i < kPadOut / 16; i += blockDim.x) cs[i] = src[i];
  for (int i = threadIdx.x; i < kBlockSize / 16; i += blockDim.x) os[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  if (threadIdx.x < 32) {
    Mover mv{};
    mv.comp = comp_s;
    mv.out = out_s;
    mv.lane = static_cast<int>(threadIdx.x);
    const bool good = snappy_block::decode_block(comp_s, comp_lens[b], out_lens[b], mv);
    uint32_t f = mv.acc;
    for (int o = 16; o > 0; o >>= 1) f ^= __shfl_xor_sync(0xFFFFFFFFu, f, o);
    if (threadIdx.x == 0) {
      ok_s = good;
      opc[b] = static_cast<int32_t>(mv.end);
      fold[b] = static_cast<int32_t>(f);
    }
  }
  __syncthreads();

  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * kBlockSize);
  for (int i = threadIdx.x; i < kBlockSize / 16; i += blockDim.x) dst[i] = os[i];
  if (threadIdx.x == 0) ok[b] = ok_s ? 1 : 0;
}

template <class Mover>
int launch(const void* comp, const void* comp_lens, const void* out_lens, void* out, void* ok, void* opc,
           void* fold, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(anatomy_kernel<Mover>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  anatomy_kernel<Mover><<<B, kThreads, kSmemBytes, stream>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_lens),
      static_cast<const int32_t*>(out_lens), static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok),
      static_cast<int32_t*>(opc), static_cast<int32_t*>(fold));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 parse, 1 window, 2 full, 3 fixed (tools/dec_anatomy.py VARIANTS).
extern "C" int snappy_dec_anatomy(const void* comp, const void* comp_lens, const void* out_lens, void* out,
                                  void* ok, void* opc, void* fold, int B, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<ParseMover>(comp, comp_lens, out_lens, out, ok, opc, fold, B, s);
    case 1: return launch<WindowMover>(comp, comp_lens, out_lens, out, ok, opc, fold, B, s);
    case 2: return launch<FullMover>(comp, comp_lens, out_lens, out, ok, opc, fold, B, s);
    case 3: return launch<FixedMover>(comp, comp_lens, out_lens, out, ok, opc, fold, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
