// K2 and K3: the Snappy block decoder, pipelined (K2) and op by op (K3).
//
// K2 replaces the TPU kernel snappytpu/kernels/decode_vm4.py
// `decode_blocks_vm4` (`_decode_kernel4`, `_block_loop_pipelined`,
// `_parse_at`, `_move` over decode_vm2's `_piece`/`_pattern`); K3 replaces
// its unpipelined twin snappytpu/kernels/decode_vm2.py `decode_blocks_vm2`
// (`_decode_kernel`, `_block_loop`).  Both compute the same function: each
// 64 KiB block's ops are parsed, validated and executed in order, and the
// block reports ok exactly as the TPU kernels do (decode_block.cuh states
// the accept set); an ok row is zero past out_len.
//
// What bounds them on the H100: the serial op chain, not bandwidth (a
// main-path batch reads ~3.3 MB and writes 8.4 MB, ~3.5 us at 3.35 TB/s).
// Each op's position depends on the previous op's header, so one block is
// one dependent chain; 128 independent blocks run on 128 of the 132 SMs, one
// thread block each (the 141 KB of shared memory a block holds allows one).
//
// K3 (decode_blocks_vm2_kernel), op by op, K2's A/B yardstick: all 256
// threads stage the whole 73728-byte row and zero the whole image, then
// warp 0 walks the ops one at a time with decode_block.cuh's decode_block;
// all 32 lanes parse the same op (a broadcast read), then move its bytes
// (WarpMover), with a __syncwarp per op.  On a dense text block an op costs
// ~440 cycles, about half parse and half move (the anatomy probe T2,
// dec_anatomy.cu, dissects this walk).
//
// K2 (decode_blocks_kernel): the parse -> move pipeline of decode_pipe.cuh.
// Warp 0 sizes 32 comp bytes per step with all its lanes and hands each
// window to warp 1 through a ring of kWinSlots slots in shared memory; warp
// 1 judges the windows (output cursors, verdicts) and hands the records
// over in batches of up to 32 through a ring of kSlots slots; warp 2 moves
// each batch group by group.  A hand-over costs one pair of named barriers
// (bar.arrive by the producer, bar.sync by the consumer, 64 threads) per
// window or batch, not per op: FULL(s) says slot s is filled, EMPTY(s) that
// its consumer has taken it.  So the time per op falls from parse + move
// toward the largest of the three, and each is shorter: a step sizes ~10
// ops of text at once, and a batch moves with one __syncwarp per group
// instead of one per op.  K2 stages only comp_len bytes of the row (rounded
// up to 16, by cp.async, then kSlack zero bytes) and zeroes only
// [out_len, 65536) of the output image; the other five warps help stage
// and write back and wait out the walk.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_block.cuh"
#include "decode_pipe.cuh"
#include "decode_ring.cuh"

namespace {

using snappy_block::kBlockSize;
using snappy_block::kPadOut;
using snappy_block::WarpMover;  // decode_block.cuh
using namespace snappy_ring;    // decode_ring.cuh: the warp policy, the rings, stage, write_back

constexpr int kThreads = 256;
constexpr size_t kSmemVm2 = kPadOut + kBlockSize;                    // K3: row + image
constexpr size_t kSmemPipe =
    kRowBytes + kBlockSize + kSlots * sizeof(Slot) + kWinSlots * sizeof(WinSlot);  // K2: + the two rings

__global__ void __launch_bounds__(kThreads)
decode_blocks_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_lens,
                     const int32_t* __restrict__ out_lens, uint8_t* __restrict__ out,
                     uint8_t* __restrict__ ok) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ok_s, halt_s;
  uint8_t* comp_s = smem;
  uint8_t* out_s = smem + kRowBytes;
  Slot* ring = reinterpret_cast<Slot*>(smem + kRowBytes + kBlockSize);
  WinSlot* windows = reinterpret_cast<WinSlot*>(smem + kRowBytes + kBlockSize + kSlots * sizeof(Slot));
  const int b = blockIdx.x;
  const int cl = comp_lens[b], ol = out_lens[b];
  const bool valid = 0 <= cl && cl <= kPadOut && 0 <= ol && ol <= kBlockSize;
  // the row's comp_len bytes; the image zeroed from out_len (rounded down to
  // 16) on, or whole for lengths out of range
  stage(comp + static_cast<size_t>(b) * kPadOut, valid ? (cl + 15) / 16 : 0, comp_s, out_s, valid ? ol / 16 : 0,
        kBlockSize / 16);
  if (threadIdx.x == 0) ok_s = halt_s = 0;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (valid && warp == 0) {
    DeviceWarp w{lane};
    WinOut out{windows, &halt_s, lane};
    snappy_pipe::size_block(w, comp_s, cl, out);
  } else if (valid && warp == 1) {
    DeviceWarp w{lane};
    WinIn in{windows, &halt_s, lane};
    RingSink sink{ring, lane};
    sink.open();
    const bool good = snappy_pipe::judge_block(w, cl, ol, 0, in, sink);
    if (lane == 0) ok_s = good;
  } else if (valid && warp == 2) {
    mover_loop(ring, lane, comp_s, out_s);
  }
  __syncthreads();

  write_back(out_s, out + static_cast<size_t>(b) * kBlockSize);
  if (threadIdx.x == 0) ok[b] = ok_s ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
decode_blocks_vm2_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_lens,
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
    const bool good = snappy_block::decode_block(comp_s, comp_lens[b], out_lens[b], mv);
    if (threadIdx.x == 0) ok_s = good;
  }
  __syncthreads();

  write_back(out_s, out + static_cast<size_t>(b) * kBlockSize);
  if (threadIdx.x == 0) ok[b] = ok_s ? 1 : 0;
}

template <class Kernel>
int launch(Kernel kernel, size_t smem, const void* comp, const void* comp_lens, const void* out_lens, void* out,
           void* ok, int B, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_lens),
      static_cast<const int32_t*>(out_lens), static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2, the main path's decoder.
extern "C" int snappy_decode_blocks(const void* comp, const void* comp_lens, const void* out_lens, void* out,
                                    void* ok, int B, void* stream) {
  return launch(decode_blocks_kernel, kSmemPipe, comp, comp_lens, out_lens, out, ok, B, stream);
}

// K3, its A/B twin.
extern "C" int snappy_decode_blocks_vm2(const void* comp, const void* comp_lens, const void* out_lens, void* out,
                                        void* ok, int B, void* stream) {
  return launch(decode_blocks_vm2_kernel, kSmemVm2, comp, comp_lens, out_lens, out, ok, B, stream);
}
