// K2: the Snappy block decoder.
//
// Replaces the TPU kernel snappytpu/kernels/decode_vm4.py
// `decode_blocks_vm4` (`_decode_kernel4`, `_block_loop_pipelined`,
// `_parse_at`, `_move` over decode_vm2's `_piece`/`_pattern`): each 64 KiB
// block's ops are parsed, validated and executed in order, and the block
// reports ok exactly as the TPU kernel does (decode_block.cuh states the
// accept set).
//
// What bounds it on the H100: the serial op chain.  Each op's position
// depends on the previous op's header, so one block is one dependent chain
// of shared-memory loads and a short byte move per op; bandwidth is not the
// limit (a main-path batch moves ~17 MB).  Parallelism comes from the batch:
// 128 independent blocks run on 128 of the 132 SMs.
//
// Design: one thread block per 64 KiB block.  All 256 threads stage the
// 73728-byte compressed row and a zeroed 65536-byte output image into
// dynamic shared memory (139264 B of the 227 KB a block may use), with
// 16-byte loads.  Then warp 0 walks the ops: every lane parses the same op
// from the same shared bytes (a broadcast read, so no shuffle is needed and
// the loop stays uniform across the warp), the 32 lanes move the op's bytes,
// and __syncwarp() orders one op's writes before the next op's reads.  A copy
// with dist < len is moved in parallel as out[opc + j] = out[opc - dist +
// j % dist], which is exactly the byte-forward overlap semantics.  Finally
// the whole image, zeros past out_len included, is written out with 16-byte
// stores.  Left out from the TPU kernel, as TPU-only devices: the software
// pipeline, packed words with masked row read-modify-writes, the 504-byte
// piece cap and same-distance chain coalescing (none changes a byte or flag).

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_block.cuh"

namespace {

using snappy_block::kBlockSize;
using snappy_block::kPadOut;
using snappy_block::WarpMover;  // decode_block.cuh

constexpr int kThreads = 256;
constexpr size_t kSmemBytes = kPadOut + kBlockSize;  // comp row + output image

__global__ void __launch_bounds__(kThreads)
decode_blocks_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_lens,
                     const int32_t* __restrict__ out_lens, uint8_t* __restrict__ out,
                     uint8_t* __restrict__ ok) {
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
    WarpMover mv{comp_s, out_s, static_cast<int>(threadIdx.x)};
    const bool good = snappy_block::decode_block(comp_s, comp_lens[b], out_lens[b], 0, mv);
    if (threadIdx.x == 0) ok_s = good;
  }
  __syncthreads();

  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * kBlockSize);
  for (int i = threadIdx.x; i < kBlockSize / 16; i += blockDim.x) dst[i] = os[i];
  if (threadIdx.x == 0) ok[b] = ok_s ? 1 : 0;
}

}  // namespace

extern "C" int snappy_decode_blocks(const void* comp, const void* comp_lens, const void* out_lens,
                                    void* out, void* ok, int B, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_blocks_kernel<<<B, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_lens),
      static_cast<const int32_t*>(out_lens), static_cast<uint8_t*>(out),
      static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}
