// K5 (and K6): the movement-only tape decoder.
//
// Replaces the TPU kernels snappytpu/kernels/decode_tape.py `_run_tape`
// (`_tape_kernel`) and `_run_tape_k` (`_tape_kernel_k`, K blocks per grid
// step).  The host builder parses and validates each block and writes its
// byte movements as records (decode_tape.cuh); the kernel only executes
// them, in order, inside the block's unified image.  ok = nrecs >= 0.
//
// What bounds it on the H100: like K2 it is one serial chain per block, since
// a record may read bytes the previous record wrote, but the chain holds no
// parse: a record is two broadcast registers and at most 504 bytes moved by
// a warp.  Its partner costs are on the host and the bus: the tape build
// (native C, one block at a time) and the tape's transfer, 8 bytes per record.
// Independent blocks run in separate thread blocks (128 on 132 SMs for a
// 128-block batch), so K6's interleaving of K blocks in one TPU grid step has
// no counterpart: K6 launches this same kernel.
//
// Design: one thread block per 64 KiB block.  All 256 threads build the
// 139,776-byte image in dynamic shared memory with 16-byte stores (zero
// guard, compressed row, zero output).  Warp 0 walks the tape: its lanes load
// 32 records at once (one coalesced 256-byte load) and each record is
// broadcast with __shfl_sync; the 32 lanes move its bytes (lane l moves bytes
// l, l + 32, ...; decode_tape.cuh says why any order is exact), then
// __syncwarp() orders them before the next record's reads.  The output
// region is then written out with 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_tape.cuh"

namespace {

using snappy_tape::kCompOff;
using snappy_tape::kImageBytes;
using snappy_tape::kOutBase;
using snappy_tape::WarpFetch;  // decode_tape.cuh
using snappy_tape::WarpMove;

constexpr int kThreads = 256;
constexpr size_t kSmemBytes = kImageBytes;
static_assert(kCompOff % 16 == 0 && kOutBase % 16 == 0 && kImageBytes % 16 == 0, "16-byte staging");

__global__ void __launch_bounds__(kThreads)
run_tape_kernel(const int32_t* __restrict__ tapes, const int32_t* __restrict__ nrecs,
                const uint8_t* __restrict__ comp, uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
                int cap) {
  extern __shared__ __align__(16) uint8_t img[];
  __shared__ int ok_s;
  const int b = blockIdx.x;

  uint4* im = reinterpret_cast<uint4*>(img);
  const uint4* src = reinterpret_cast<const uint4*>(comp + static_cast<size_t>(b) * snappy_block::kPadOut);
  for (int i = threadIdx.x; i < kImageBytes / 16; i += blockDim.x) {
    const bool in_comp = i >= kCompOff / 16 && i < kOutBase / 16;
    im[i] = in_comp ? src[i - kCompOff / 16] : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = static_cast<int>(threadIdx.x);
    const int64_t nr = nrecs[b];
    WarpFetch fetch{reinterpret_cast<const int2*>(tapes) + static_cast<size_t>(b) * cap, nr, lane,
                    make_int2(0, 0)};
    WarpMove move{img, lane};
    const bool good = snappy_tape::run_tape(nr, cap, fetch, move);
    if (lane == 0) ok_s = good;
  }
  __syncthreads();

  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * snappy_block::kBlockSize);
  for (int i = threadIdx.x; i < snappy_block::kBlockSize / 16; i += blockDim.x) dst[i] = im[kOutBase / 16 + i];
  if (threadIdx.x == 0) ok[b] = ok_s ? 1 : 0;
}

}  // namespace

// tapes: (B, cap) records of two int32 words; nrecs, comp: as the TPU kernel.
extern "C" int snappy_run_tape(const void* tapes, const void* nrecs, const void* comp, void* out, void* ok,
                               int B, int cap, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      run_tape_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  run_tape_kernel<<<B, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tapes), static_cast<const int32_t*>(nrecs), static_cast<const uint8_t*>(comp),
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok), cap);
  return static_cast<int>(cudaGetLastError());
}
