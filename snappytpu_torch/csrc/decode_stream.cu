// K4: the windowed stream decoder, a parallel parse (K4a) and a serial move
// (K4b).
//
// Replaces the TPU kernel snappytpu/kernels/decode_vm2.py `decode_stream_vm`
// (`_stream_kernel` over `_block_loop`): N op chunks, cut at op boundaries,
// are decoded in order; chunk i's copies may reach ctx_lens[i] bytes before
// its own output, into the chunks before it or the caller's 64 KiB ctx0.
// The accept set is K2's (decode_block.cuh's op_rules, with ctx_len > 0).
//
// What bounds it on the H100: the chunks depend on each other only through
// their bytes.  Whether an op is good, and where it reads and writes, needs
// only the chunk's comp bytes and its comp_len, out_len and ctx_len, all
// known up front; only the moves are serial across chunks, since a copy may
// read the output of the chunk before.  Bandwidth is far off (a 64-chunk
// call moves ~6 MB, ~1.7 us at 3.35 TB/s).
//
// Design: two launches per call, joined by a buffer of records in device
// memory ((N, cap) of decode_pipe.cuh's Rec, cap = 73728 / 2, since an op
// takes two comp bytes or more).
//   * K4a (stream_parse_kernel), grid N: one thread block per chunk, all
//     chunks at once.  It stages the chunk's comp_len bytes by cp.async and
//     runs K2's sizer and judge warps (decode_pipe.cuh, over decode_ring.cuh's
//     window ring), the judge with the chunk's ctx_len clamped to
//     [0, 65536]; the judge's records go straight to the buffer, copy sources
//     as offsets from the chunk's first output byte (negative into the
//     context).  A malformed chunk's records are the ops before its first
//     bad op, which the TPU kernel also moves; lengths out of range give not
//     ok and no records.  It writes ok and the record count.
//   * K4b (stream_move_kernel), one thread block: the chunks in order over a
//     linear image in shared memory, 64 KiB of context followed by the
//     chunk's 64 KiB of output.  Per chunk all threads stage its comp row
//     (literal records read it) and zero the output region; warp 0 moves the
//     records a batch of 32 at a time with K2's move_batch (move_records,
//     the next batch's loads in flight); all threads write the row out with
//     16-byte stores and slide the window by out_len when
//     0 < out_len <= 65536, ok or not, as the TPU kernel does: the last
//     64 KiB move down, an unaligned move read whole into registers a round
//     at a time before it is written.  Because the image is linear, the
//     mover addresses it as K2 does, words and all.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_pipe.cuh"
#include "decode_ring.cuh"

namespace {

using namespace snappy_ring;  // decode_ring.cuh: the warp policy, the window ring, stage, write_back

constexpr int kThreads = 256;
constexpr int kImage = 2 * kBlockSize;  // K4b's context + output
constexpr int kSlideWords = 8;          // words per thread per round of the slide
constexpr size_t kSmemParse = kRowBytes + kWinSlots * sizeof(WinSlot);
constexpr size_t kSmemMove = kImage + 16 + kRowBytes;  // the slide reads a word past the image

// The judge's records, in order, to the chunk's part of the buffer.
struct RecordSink {
  Rec* recs;
  int count = 0;
  __host__ __device__ Rec* room(int) { return recs + count; }
  __host__ __device__ void commit(int n) { count += n; }
  __host__ __device__ void finish() {}
};

__global__ void __launch_bounds__(kThreads)
stream_parse_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_lens,
                    const int32_t* __restrict__ out_lens, const int32_t* __restrict__ ctx_lens, Rec* __restrict__ recs,
                    int32_t* __restrict__ nrecs, uint8_t* __restrict__ ok, int cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ok_s, halt_s, n_s;
  uint8_t* comp_s = smem;
  WinSlot* windows = reinterpret_cast<WinSlot*>(smem + kRowBytes);
  const int c = blockIdx.x;
  const int cl = comp_lens[c], ol = out_lens[c];
  const bool valid = 0 <= cl && cl <= kPadOut && 0 <= ol && ol <= kBlockSize;
  stage(comp + static_cast<size_t>(c) * kPadOut, valid ? (cl + 15) / 16 : 0, comp_s, nullptr, 0, 0);
  if (threadIdx.x == 0) ok_s = halt_s = n_s = 0;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (valid && warp == 0) {
    DeviceWarp w{lane};
    WinOut out{windows, &halt_s, lane};
    snappy_pipe::size_block(w, comp_s, cl, out);
  } else if (valid && warp == 1) {
    DeviceWarp w{lane};
    WinIn in{windows, &halt_s, lane};
    RecordSink sink{recs + static_cast<size_t>(c) * cap};
    const int32_t want = ctx_lens[c];
    const int32_t ctx_len = want < 0 ? 0 : (want > kBlockSize ? kBlockSize : want);
    const bool good = snappy_pipe::judge_block(w, cl, ol, ctx_len, in, sink);
    if (lane == 0) {
      ok_s = good;
      n_s = sink.count;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    ok[c] = ok_s ? 1 : 0;
    nrecs[c] = n_s;
  }
}

// img[0, 65536) = img[s, s + 65536) for 0 < s <= 65536, by all threads:
// rounds of kThreads * kSlideWords words, each read whole (two aligned
// words and a funnel shift per word) before any of it is written.  A round
// reads at or above the words it writes, so no round reads what an earlier
// one wrote.
__device__ void slide(uint8_t* img, int s) {
  uint32_t* words = reinterpret_cast<uint32_t*>(img);
  const int base = s >> 2;
  const uint32_t shift = static_cast<uint32_t>(s & 3) * 8;
  for (int r = 0; r < kBlockSize / 4; r += kThreads * kSlideWords) {
    uint32_t v[kSlideWords];
#pragma unroll
    for (int k = 0; k < kSlideWords; ++k) {
      const int i = base + r + k * kThreads + threadIdx.x;
      v[k] = __funnelshift_r(words[i], words[i + 1], shift);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlideWords; ++k) words[r + k * kThreads + threadIdx.x] = v[k];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
stream_move_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_lens,
                   const int32_t* __restrict__ out_lens, const uint8_t* __restrict__ ctx0,
                   const Rec* __restrict__ recs, const int32_t* __restrict__ nrecs, uint8_t* __restrict__ out, int N,
                   int cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* img = smem;                    // [0, 65536) the window, [65536, 131072) the chunk's output
  uint8_t* out_s = smem + kBlockSize;
  uint8_t* comp_s = smem + kImage + 16;
  const uint4* c0 = reinterpret_cast<const uint4*>(ctx0);
  for (int i = threadIdx.x; i < kBlockSize / 16; i += blockDim.x) reinterpret_cast<uint4*>(img)[i] = c0[i];
  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(img + kImage)[threadIdx.x] = 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = 0; c < N; ++c) {
    const int cl = comp_lens[c], ol = out_lens[c];
    const bool valid = 0 <= cl && cl <= kPadOut;  // K4a gave a chunk with a length out of range no records
    stage(comp + static_cast<size_t>(c) * kPadOut, valid ? (cl + 15) / 16 : 0, comp_s, out_s, 0, kBlockSize / 16);
    __syncthreads();
    if (warp == 0) {
      DeviceWarp w{lane};
      snappy_pipe::move_records(w, recs + static_cast<size_t>(c) * cap, nrecs[c], comp_s, out_s);
    }
    __syncthreads();
    write_back(out_s, out + static_cast<size_t>(c) * kBlockSize);
    if (0 < ol && ol <= kBlockSize) slide(img, ol);  // reads out_s, as write_back does, and writes below it
    __syncthreads();  // the next chunk restages the row and zeroes the output
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

}  // namespace

// K4a: (comp, comp_lens, out_lens, ctx_lens) of N chunks -> recs (N, cap),
// nrecs (N,), ok (N,).
extern "C" int snappy_decode_stream_parse(const void* comp, const void* comp_lens, const void* out_lens,
                                          const void* ctx_lens, void* recs, void* nrecs, void* ok, int N, int cap,
                                          void* stream) {
  cudaError_t err = allow_smem(stream_parse_kernel, kSmemParse);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_parse_kernel<<<N, kThreads, kSmemParse, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_lens),
      static_cast<const int32_t*>(out_lens), static_cast<const int32_t*>(ctx_lens), static_cast<Rec*>(recs),
      static_cast<int32_t*>(nrecs), static_cast<uint8_t*>(ok), cap);
  return static_cast<int>(cudaGetLastError());
}

// K4b: K4a's records of N chunks, their rows and lengths, and ctx0 -> out (N, 65536).
extern "C" int snappy_decode_stream_move(const void* comp, const void* comp_lens, const void* out_lens,
                                         const void* ctx0, const void* recs, const void* nrecs, void* out, int N,
                                         int cap, void* stream) {
  cudaError_t err = allow_smem(stream_move_kernel, kSmemMove);
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_move_kernel<<<1, kThreads, kSmemMove, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_lens),
      static_cast<const int32_t*>(out_lens), static_cast<const uint8_t*>(ctx0), static_cast<const Rec*>(recs),
      static_cast<const int32_t*>(nrecs), static_cast<uint8_t*>(out), N, cap);
  return static_cast<int>(cudaGetLastError());
}
