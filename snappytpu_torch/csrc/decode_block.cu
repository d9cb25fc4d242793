// K2 and K3: the Snappy block decoder, pipelined (K2) and as a parse and a
// resolve (K3).
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
// What bounds them on the H100: not bandwidth (a main-path batch reads
// ~3.3 MB and writes 8.4 MB, ~3.5 us at 3.35 TB/s).  Each op's position
// depends on the previous op's header, and a copy reads what earlier ops
// wrote: walked op by op, a block is one dependent chain.  128 independent
// blocks run on 128 of the 132 SMs, one thread block each.
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
//
// K3, K2's A/B twin, takes the mover off the chain: two launches, joined by
// a record buffer in device memory (kernels/decode_vm2.py makes both).
//   * K4a's parse (decode_stream.cu stream_parse_kernel) with every ctx_len
//     0: K2's sizer and judge, one thread block per block, write each
//     block's records (a literal {at, ip + hdr, len, 0}, a copy
//     {at, at - dist, len, dist}; a malformed block's ops before its first
//     bad op, none for lengths out of range), their count and K2's ok.
//   * resolve_blocks_kernel, 1024 threads per block: decode_resolve.cuh's
//     resolver over those records.  Every byte takes its record's source (a
//     row byte from global memory, or a pointer to an earlier output byte),
//     then rounds of pointer jumping over a 64 KiB image and a 128 KiB
//     uint16 pointer array in shared memory resolve every chain at once.
//     A copy reads only before its own output, so the records are always
//     in the resolver's order and K3 needs no walk.  ok = the parse's ok
//     and every byte resolved within 17 rounds (16 always suffice).
// The op-by-op walk that K3 ran until it was redesigned stays in
// decode_block.cuh (decode_block) as the host tests' statement of the
// accept set; no kernel runs it.  The anatomy probe T2 (dec_anatomy.cu)
// dissects K2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_block.cuh"
#include "decode_pipe.cuh"
#include "decode_resolve.cuh"
#include "decode_ring.cuh"

namespace {

using snappy_block::kBlockSize;
using snappy_block::kPadOut;
using namespace snappy_ring;  // decode_ring.cuh: the warp policy, the rings, stage, write_back

constexpr int kThreads = 256;
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

__global__ void __launch_bounds__(snappy_resolve::kThreads)
resolve_blocks_kernel(const uint8_t* __restrict__ comp, const Rec* __restrict__ recs,
                      const int32_t* __restrict__ nrecs, const uint8_t* __restrict__ parsed_ok,
                      uint8_t* __restrict__ out, uint8_t* __restrict__ ok, int32_t* __restrict__ rounds, int cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ snappy_resolve::BlockScratch scratch;
  const int b = blockIdx.x;
  snappy_resolve::DeviceBlock blk{&scratch};
  const snappy_resolve::Image im{smem, reinterpret_cast<uint16_t*>(smem + kBlockSize),
                                 comp + static_cast<size_t>(b) * kPadOut};
  const snappy_resolve::RecSpans spans{recs + static_cast<size_t>(b) * cap};
  const int32_t n = nrecs[b];  // K4a's count, 0 <= n <= cap
  const int r = snappy_resolve::resolve(blk, im, spans, n < 0 ? 0 : (n > cap ? cap : n));
  write_back(im.out, out + static_cast<size_t>(b) * kBlockSize);
  if (threadIdx.x == 0) {
    ok[b] = parsed_ok[b] && r <= snappy_resolve::kMaxRounds ? 1 : 0;
    rounds[b] = r;
  }
}

}  // namespace

// K2, the main path's decoder.
extern "C" int snappy_decode_blocks(const void* comp, const void* comp_lens, const void* out_lens, void* out,
                                    void* ok, int B, void* stream) {
  cudaError_t err = snappy_ring::allow_smem(decode_blocks_kernel, kSmemPipe);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_blocks_kernel<<<B, kThreads, kSmemPipe, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_lens),
      static_cast<const int32_t*>(out_lens), static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

// K3's second launch: K4a's records (B, cap) of B blocks, their counts and
// ok flags, and the rows -> out (B, 65536), ok (B,), rounds (B,) int32.
extern "C" int snappy_resolve_blocks(const void* comp, const void* recs, const void* nrecs, const void* parsed_ok,
                                     void* out, void* ok, void* rounds, int B, int cap, void* stream) {
  constexpr size_t smem = snappy_resolve::kSmemBytes;
  cudaError_t err = snappy_ring::allow_smem(resolve_blocks_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  resolve_blocks_kernel<<<B, snappy_resolve::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const Rec*>(recs), static_cast<const int32_t*>(nrecs),
      static_cast<const uint8_t*>(parsed_ok), static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok),
      static_cast<int32_t*>(rounds), cap);
  return static_cast<int>(cudaGetLastError());
}
