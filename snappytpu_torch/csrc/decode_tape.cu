// K5 and K6: the movement-only tape decoder, on K2's grouped mover (K5) and
// record by record (K6).
//
// Replaces the TPU kernels snappytpu/kernels/decode_tape.py `_run_tape`
// (`_tape_kernel`) and `_run_tape_k` (`_tape_kernel_k`, K blocks per grid
// step).  The host builder parses and validates each block and writes its
// byte movements as records (decode_tape.cuh); the kernel only executes
// them, in order, inside the block's unified image.  ok = nrecs >= 0, and
// every record passes in_image.
//
// What bounds them on the H100: like K2 each is one serial chain per block,
// since a record may read bytes an earlier record wrote; not bandwidth (a
// 128-block batch moves ~12 MB, ~3.6 us at 3.35 TB/s).  Independent blocks
// run in separate thread blocks (128 on 132 SMs for a 128-block batch), so
// K6's interleaving of K blocks in one TPU grid step has no counterpart.
//
// Both: one thread block per 64 KiB block.  All 256 threads build the
// 139,776-byte image in dynamic shared memory with 16-byte stores (zero
// guard, compressed row, zero output), and write its output region out at
// the end with 16-byte stores.
//
// K5 (run_tape_kernel): warp 0 is decode_tape.cuh's producer.  Its lanes
// load 32 records per step (one coalesced 256-byte load, the next step's in
// flight), check them at once, and hand the ones before the first refused
// record over as one batch through decode_ring.cuh's record ring, as K2's
// judge does; warp 1 moves each batch with move_batch (decode_pipe.cuh):
// pieces of one literal or one long copy join into one record, moved a word
// per lane from 128 bytes on, and a batch costs one __syncwarp per group of
// records that read nothing the group writes, not one per record.
//
// K6 (run_tape_k_kernel), K5's A/B yardstick, keeps K5's walk before it:
// warp 0 alone loads 32 records at once and broadcasts each with
// __shfl_sync; the 32 lanes move its bytes (lane l moves bytes l, l + 32,
// ...; decode_tape.cuh says why any order is exact), then __syncwarp()
// orders them before the next record's reads.  The tape probe T3
// (tape_probe.cu) dissects this walk.

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kThreads = 256;
constexpr size_t kSmemK6 = kImageBytes;
constexpr size_t kSmemK5 = kImageBytes + snappy_ring::kSlots * sizeof(Slot);  // + the record ring
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

__global__ void __launch_bounds__(kThreads)
run_tape_k_kernel(const int32_t* __restrict__ tapes, const int32_t* __restrict__ nrecs,
                  const uint8_t* __restrict__ comp, uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
                  int cap) {
  extern __shared__ __align__(16) uint8_t img[];
  __shared__ int ok_s;
  const int b = blockIdx.x;
  build_image(comp + static_cast<size_t>(b) * snappy_block::kPadOut, img);
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

  snappy_ring::write_back(img + kOutBase, out + static_cast<size_t>(b) * snappy_block::kBlockSize);
  if (threadIdx.x == 0) ok[b] = ok_s ? 1 : 0;
}

template <class Kernel>
int launch(Kernel kernel, size_t smem, const void* tapes, const void* nrecs, const void* comp, void* out, void* ok,
           int B, int cap, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tapes), static_cast<const int32_t*>(nrecs), static_cast<const uint8_t*>(comp),
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok), cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tapes: (B, cap) records of two int32 words; nrecs, comp: as the TPU kernel.
// K5, the tape route's decoder.
extern "C" int snappy_run_tape(const void* tapes, const void* nrecs, const void* comp, void* out, void* ok,
                               int B, int cap, void* stream) {
  return launch(run_tape_kernel, kSmemK5, tapes, nrecs, comp, out, ok, B, cap, stream);
}

// K6, its A/B yardstick.
extern "C" int snappy_run_tape_k(const void* tapes, const void* nrecs, const void* comp, void* out, void* ok,
                                 int B, int cap, void* stream) {
  return launch(run_tape_k_kernel, kSmemK6, tapes, nrecs, comp, out, ok, B, cap, stream);
}
