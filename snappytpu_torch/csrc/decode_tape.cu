// K5 and K6: the movement-only tape decoder, on K2's grouped mover (K5) and
// on the byte-source resolver (K6).
//
// Replaces the TPU kernels snappytpu/kernels/decode_tape.py `_run_tape`
// (`_tape_kernel`) and `_run_tape_k` (`_tape_kernel_k`, K blocks per grid
// step).  The host builder parses and validates each block and writes its
// byte movements as records (decode_tape.cuh); the kernel only executes
// them, in order, inside the block's unified image.  ok = nrecs >= 0, and
// every record passes in_image.
//
// What bounds them on the H100: not bandwidth (a 128-block batch moves
// ~12 MB, ~3.6 us at 3.35 TB/s).  A record may read bytes an earlier record
// wrote, so a walk of the records is one serial chain per block (K5); K6
// resolves every byte's chain at once instead.  Independent blocks run in
// separate thread blocks (128 on 132 SMs for a 128-block batch), so K6's
// interleaving of K blocks in one TPU grid step has no counterpart.
//
// K5 (run_tape_kernel), 256 threads: all build the 139,776-byte image in
// dynamic shared memory with 16-byte stores (zero guard, compressed row,
// zero output) and write its output region out at the end with 16-byte
// stores.  Warp 0 is decode_tape.cuh's producer.  Its lanes load 32 records
// per step (one coalesced 256-byte load, the next step's in flight), check
// them at once, and hand the ones before the first refused record over as
// one batch through decode_ring.cuh's record ring, as K2's judge does; warp
// 1 moves each batch with move_batch (decode_pipe.cuh): pieces of one
// literal or one long copy join into one record, moved a word per lane from
// 128 bytes on, and a batch costs one __syncwarp per group of records that
// read nothing the group writes, not one per record.
//
// K6 (run_tape_k_kernel), 1024 threads: decode_resolve.cuh's run_tape_block.
// The threads check the records 1024 at a time (a warp's 32 in one
// coalesced load): the first refused one, and whether the records before it
// write the output region in ascending order, are block minimums.  Every
// builder tape is so, and its bytes are resolved by pointer jumping over a
// 64 KiB image and a 128 KiB uint16 pointer array in shared memory: each
// byte takes its record's source (a row byte read from global memory, zero,
// or a pointer to an earlier output byte), then rounds of jumps, each fully
// parallel, until every chain has reached its end (16 rounds at most).  A
// hand-made tape whose records are not in that order runs the record walk
// of decode_tape.cuh (run_tape with WarpFetch / WarpMove: warp 0 loads 32
// records at once and broadcasts each, the lanes move its bytes) over the
// whole image in the same kernel: the same function on other inputs,
// decided on the card per block, with the same rows and flags as the
// resolver would give where both are exact.  The tape probe T3
// (tape_probe.cu) dissects K5.  rounds[b] is the resolver's round
// count, or -1 for a block that ran the walk.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_resolve.cuh"
#include "decode_ring.cuh"
#include "decode_tape.cuh"

namespace {

using snappy_ring::DeviceWarp;
using snappy_ring::Slot;
using snappy_tape::kCompOff;
using snappy_tape::kImageBytes;
using snappy_tape::kOutBase;
using snappy_tape::WarpFetch;  // decode_tape.cuh
using snappy_tape::WarpMove;

constexpr int kThreads = 256;  // K5's
constexpr size_t kSmemK6 = kImageBytes > snappy_resolve::kSmemBytes ? kImageBytes : snappy_resolve::kSmemBytes;
constexpr size_t kSmemK5 = kImageBytes + snappy_ring::kSlots * sizeof(Slot);  // + the record ring
static_assert(kSmemK6 + sizeof(snappy_resolve::BlockScratch) + sizeof(int) <= snappy_resolve::kSmemLimit,
              "K6's shared memory: the resolver's image and pointers, or the walk's image, and the scratch");
static_assert(kCompOff % 16 == 0 && kOutBase % 16 == 0 && kImageBytes % 16 == 0, "16-byte staging");

__device__ void build_image(const uint8_t* row, uint8_t* img) {
  uint4* im = reinterpret_cast<uint4*>(img);
  const uint4* src = reinterpret_cast<const uint4*>(row);
  for (int i = threadIdx.x; i < kImageBytes / 16; i += blockDim.x) {
    const bool in_comp = i >= kCompOff / 16 && i < kOutBase / 16;
    im[i] = in_comp ? src[i - kCompOff / 16] : make_uint4(0, 0, 0, 0);
  }
}

// The producer's loads: lane l gets record r + l's two words, zeros past
// nrecs.  __host__ __device__ only so that produce_tape instantiates.
struct TapeLoad {
  const int2* tape;
  int32_t nrecs;
  int lane;

  __host__ __device__ void operator()(DeviceWarp&, int32_t r, DeviceWarp::Var<int32_t>& w0,
                                      DeviceWarp::Var<int32_t>& w1) const {
#ifdef __CUDA_ARCH__
    const int32_t i = r + lane;
    const int2 v = i < nrecs ? __ldg(tape + i) : make_int2(0, 0);
    w0.v = v.x;
    w1.v = v.y;
#endif
  }
};

__global__ void __launch_bounds__(kThreads)
run_tape_kernel(const int32_t* __restrict__ tapes, const int32_t* __restrict__ nrecs,
                const uint8_t* __restrict__ comp, uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
                int cap) {
  extern __shared__ __align__(16) uint8_t img[];
  __shared__ int ok_s;
  Slot* ring = reinterpret_cast<Slot*>(img + kImageBytes);
  const int b = blockIdx.x;
  build_image(comp + static_cast<size_t>(b) * snappy_block::kPadOut, img);
  if (threadIdx.x == 0) ok_s = 0;
  __syncthreads();

  const int32_t nr = nrecs[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (0 <= nr && nr <= cap && warp == 0) {
    DeviceWarp w{lane};
    TapeLoad load{reinterpret_cast<const int2*>(tapes) + static_cast<size_t>(b) * cap, nr, lane};
    snappy_ring::RingSink sink{ring, lane};
    sink.open();
    const bool good = snappy_tape::produce_tape(w, nr, load, sink);
    if (lane == 0) ok_s = good;
  } else if (0 <= nr && nr <= cap && warp == 1) {
    snappy_ring::mover_loop(ring, lane, img, img);
  }
  __syncthreads();

  snappy_ring::write_back(img + kOutBase, out + static_cast<size_t>(b) * snappy_block::kBlockSize);
  if (threadIdx.x == 0) ok[b] = ok_s ? 1 : 0;
}

// K6's record fetch: tape record r, one 8-byte load.  __host__ __device__
// only so that decode_resolve.cuh's templates instantiate.
struct TapeFetch {
  const int2* tape;
  __host__ __device__ snappy_tape::Record operator()(int32_t r) const {
#ifdef __CUDA_ARCH__
    const int2 w = __ldg(tape + r);
    return snappy_tape::decode_record(w.x, w.y);
#else
    (void)r;
    return snappy_tape::Record{};
#endif
  }
};

// K6's walk for a tape the resolver is not exact on: all threads build the
// unified image, warp 0 runs the record walk, all see its ok.
struct TapeWalk {
  uint8_t* img;
  const uint8_t* row;
  const int2* tape;
  int64_t nrecs;
  int64_t cap;
  int* ok_s;
  __host__ __device__ bool operator()() const {
#ifdef __CUDA_ARCH__
    build_image(row, img);
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lane = static_cast<int>(threadIdx.x);
      WarpFetch fetch{tape, nrecs, lane, make_int2(0, 0)};
      WarpMove move{img, lane};
      const bool good = snappy_tape::run_tape(nrecs, cap, fetch, move);
      if (lane == 0) *ok_s = good;
    }
    __syncthreads();
    return *ok_s != 0;
#else
    return false;
#endif
  }
};

__global__ void __launch_bounds__(snappy_resolve::kThreads)
run_tape_k_kernel(const int32_t* __restrict__ tapes, const int32_t* __restrict__ nrecs,
                  const uint8_t* __restrict__ comp, uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
                  int32_t* __restrict__ rounds, int cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ snappy_resolve::BlockScratch scratch;
  __shared__ int ok_s;
  const int b = blockIdx.x;
  const uint8_t* row = comp + static_cast<size_t>(b) * snappy_block::kPadOut;
  const int2* tape = reinterpret_cast<const int2*>(tapes) + static_cast<size_t>(b) * cap;
  const int32_t nr = nrecs[b];
  snappy_resolve::DeviceBlock blk{&scratch};
  const snappy_resolve::Image im{smem, reinterpret_cast<uint16_t*>(smem + snappy_block::kBlockSize), row};
  const TapeFetch fetch{tape};
  TapeWalk walk{smem, row, tape, nr, cap, &ok_s};
  const snappy_resolve::Outcome res = snappy_resolve::run_tape_block(blk, fetch, nr, cap, im, walk);
  __syncthreads();  // the walk's image is written by warp 0 alone
  snappy_ring::write_back(res.rounds == snappy_resolve::kWalked ? smem + kOutBase : im.out,
                          out + static_cast<size_t>(b) * snappy_block::kBlockSize);
  if (threadIdx.x == 0) {
    ok[b] = res.ok ? 1 : 0;
    rounds[b] = res.rounds;
  }
}

}  // namespace

// tapes: (B, cap) records of two int32 words; nrecs, comp: as the TPU kernel.
// K5, the tape route's decoder.
extern "C" int snappy_run_tape(const void* tapes, const void* nrecs, const void* comp, void* out, void* ok,
                               int B, int cap, void* stream) {
  cudaError_t err = snappy_ring::allow_smem(run_tape_kernel, kSmemK5);
  if (err != cudaSuccess) return static_cast<int>(err);
  run_tape_kernel<<<B, kThreads, kSmemK5, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tapes), static_cast<const int32_t*>(nrecs), static_cast<const uint8_t*>(comp),
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok), cap);
  return static_cast<int>(cudaGetLastError());
}

// K6, its A/B twin; rounds (B,) int32 as run_tape_k_kernel writes them.
extern "C" int snappy_run_tape_k(const void* tapes, const void* nrecs, const void* comp, void* out, void* ok,
                                 void* rounds, int B, int cap, void* stream) {
  cudaError_t err = snappy_ring::allow_smem(run_tape_k_kernel, kSmemK6);
  if (err != cudaSuccess) return static_cast<int>(err);
  run_tape_k_kernel<<<B, snappy_resolve::kThreads, kSmemK6, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tapes), static_cast<const int32_t*>(nrecs), static_cast<const uint8_t*>(comp),
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok), static_cast<int32_t*>(rounds), cap);
  return static_cast<int>(cudaGetLastError());
}
