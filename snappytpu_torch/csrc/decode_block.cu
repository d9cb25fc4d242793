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

namespace {

using snappy_block::kBlockSize;
using snappy_block::kPadOut;
using snappy_block::WarpMover;  // decode_block.cuh
using snappy_pipe::kBatch;
using snappy_pipe::kSlack;
using snappy_pipe::Rec;

constexpr int kThreads = 256;
constexpr int kSlots = 3;     // record batches in flight, judge -> mover
constexpr int kWinSlots = 4;  // windows in flight, sizer -> judge
constexpr int kPair = 64;     // threads at a named barrier: the two warps of a ring

struct Slot {
  Rec recs[kBatch];
  int n;     // records in the batch
  int last;  // the parse ended with this batch
  int pad[2];
};

// A sized window: where it starts, its op starts, whether it is the last,
// and per lane the op header and length (decode_pipe.cuh's Window).
struct WinSlot {
  uint32_t w[32];
  uint32_t b4[32];
  int32_t len[32];
  int32_t ip;
  uint32_t starts;
  int32_t last;
  int32_t pad;
};

constexpr size_t kRowBytes = kPadOut + kSlack;
constexpr size_t kSmemVm2 = kPadOut + kBlockSize;                    // K3: row + image
constexpr size_t kSmemPipe =
    kRowBytes + kBlockSize + kSlots * sizeof(Slot) + kWinSlots * sizeof(WinSlot);  // K2: + the two rings

__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kPair) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kPair) : "memory");
}
// Named barriers (0 is __syncthreads): FULL and EMPTY of each slot of the
// record ring, then of each slot of the window ring; 1 + 2 * (3 + 4) = 15
// of the 16 a block has.
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + kSlots + s; }
__device__ __forceinline__ int win_full_bar(int s) { return 1 + 2 * kSlots + s; }
__device__ __forceinline__ int win_empty_bar(int s) { return 1 + 2 * kSlots + kWinSlots + s; }

// The warp policy of decode_pipe.cuh on the device: one lane per thread.
// Its methods, and the ring sink's, are __host__ __device__ only so that
// decode_pipe.cuh's __host__ __device__ templates instantiate; the host side
// is never called.
struct DeviceWarp {
  template <class T>
  struct Var {
    T v;
    __host__ __device__ T& operator[](int) { return v; }
    __host__ __device__ const T& operator[](int) const { return v; }
  };
  int lane;
  template <class F>
  __host__ __device__ void each(F f) { f(lane); }
  __host__ __device__ int32_t shfl(const Var<int32_t>& x, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xFFFFFFFFu, x.v, src);
#else
    (void)src;
    return x.v;
#endif
  }
  __host__ __device__ Var<int32_t> gather(const Var<int32_t>& x, const Var<int32_t>& i) const {
#ifdef __CUDA_ARCH__
    return Var<int32_t>{__shfl_sync(0xFFFFFFFFu, x.v, i.v)};
#else
    (void)i;
    return x;
#endif
  }
  __host__ __device__ int32_t reduce_or(const Var<int32_t>& x) const {
#ifdef __CUDA_ARCH__
    return static_cast<int32_t>(__reduce_or_sync(0xFFFFFFFFu, static_cast<unsigned>(x.v)));
#else
    return x.v;
#endif
  }
  __host__ __device__ uint32_t ballot(const Var<bool>& p) const {
#ifdef __CUDA_ARCH__
    return __ballot_sync(0xFFFFFFFFu, p.v);
#else
    return p.v;
#endif
  }
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
  __host__ __device__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
};

// The sizer's end of the window ring: window f goes to slot f % kWinSlots,
// which the sizer first waits to be empty once the judge has had it.  The
// judge raises *halt when it has ended the block.
struct WinOut {
  WinSlot* ring;
  volatile int* halt;
  int lane;
  int f = 0;  // windows handed over

  __host__ __device__ bool stopped(DeviceWarp&) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xFFFFFFFFu, lane == 0 ? *halt : 0, 0) != 0;
#else
    return false;
#endif
  }
  __host__ __device__ void push(DeviceWarp&, int32_t ip, const snappy_pipe::Window<DeviceWarp>& win, bool last) {
#ifdef __CUDA_ARCH__
    if (f >= kWinSlots) bar_sync(win_empty_bar(f % kWinSlots));
    WinSlot& slot = ring[f % kWinSlots];
    slot.w[lane] = win.head[lane].w;
    slot.b4[lane] = win.head[lane].b4;
    slot.len[lane] = win.op[lane].len;
    if (lane == 0) {
      slot.ip = ip;
      slot.starts = win.starts;
      slot.last = last;
    }
    __threadfence_block();
    bar_arrive(win_full_bar(f % kWinSlots));
    ++f;
    // after the last window, take back the judge's last EMPTYs
    if (last)
      for (int g = f > kWinSlots ? f - kWinSlots : 0; g < f; ++g) bar_sync(win_empty_bar(g % kWinSlots));
#endif
  }
};

// The judge's end of the window ring.  finish() raises *halt and takes the
// windows still coming up to the last, so that the sizer ends.
struct WinIn {
  WinSlot* ring;
  volatile int* halt;
  int lane;
  int f = 0;          // windows taken
  bool last = false;  // the window taken last was the sizer's last

  __host__ __device__ void take(DeviceWarp&, int32_t& ip, uint32_t& starts, DeviceWarp::Var<snappy_pipe::Head>& head,
                                DeviceWarp::Var<int32_t>& len) {
#ifdef __CUDA_ARCH__
    bar_sync(win_full_bar(f % kWinSlots));
    const WinSlot& slot = ring[f % kWinSlots];
    head.v = snappy_pipe::Head{slot.w[lane], slot.b4[lane]};
    len.v = slot.len[lane];
    ip = slot.ip;
    starts = slot.starts;
    last = slot.last != 0;
#endif
  }
  __host__ __device__ void release(DeviceWarp&) {
#ifdef __CUDA_ARCH__
    bar_arrive(win_empty_bar(f % kWinSlots));
#endif
    ++f;
  }
  __host__ __device__ void finish(DeviceWarp& w) {
#ifdef __CUDA_ARCH__
    if (lane == 0) *halt = 1;
    int32_t ip;
    uint32_t starts;
    DeviceWarp::Var<snappy_pipe::Head> head;
    DeviceWarp::Var<int32_t> len;
    while (!last) {
      take(w, ip, starts, head, len);
      release(w);
    }
#endif
  }
};

// The judge's end of the record ring: batch f goes to slot f % kSlots,
// which the judge first waits to be empty once the mover has had it.
struct RingSink {
  Slot* ring;
  int lane;
  int f = 0;      // batches handed over
  int count = 0;  // records in the open batch

  __host__ __device__ void open() {
#ifdef __CUDA_ARCH__
    if (f >= kSlots) bar_sync(empty_bar(f % kSlots));
#endif
  }
  __host__ __device__ void hand_over(bool last) {
#ifdef __CUDA_ARCH__
    if (lane == 0) {
      ring[f % kSlots].n = count;
      ring[f % kSlots].last = last;
    }
    __threadfence_block();
    bar_arrive(full_bar(f % kSlots));
#endif
    ++f;
    count = 0;
  }
  __host__ __device__ Rec* room(int n) {
    if (count + n > kBatch) {
      hand_over(false);
      open();
    }
    return ring[f % kSlots].recs + count;
  }
  __host__ __device__ void commit(int n) { count += n; }
  __host__ __device__ void finish() {
    hand_over(true);
    // take back the mover's last EMPTY of every slot, so no barrier is left
    // half-arrived
#ifdef __CUDA_ARCH__
    for (int g = f > kSlots ? f - kSlots : 0; g < f; ++g) bar_sync(empty_bar(g % kSlots));
#endif
  }
};

__device__ void mover_loop(Slot* ring, int lane, const uint8_t* comp_s, uint8_t* out_s) {
  DeviceWarp w{lane};
  for (int f = 0;; ++f) {
    Slot& slot = ring[f % kSlots];
    bar_sync(full_bar(f % kSlots));
    const int n = slot.n;
    const bool last = slot.last;
    DeviceWarp::Var<Rec> rec{lane < n ? slot.recs[lane] : Rec{0, 0, 0, 0}};
    bar_arrive(empty_bar(f % kSlots));
    snappy_pipe::move_batch(w, rec, n, comp_s, out_s);
    if (last) return;
  }
}

// Stage the row's first comp_len bytes (rounded up to 16) by cp.async with
// kSlack zero bytes after them, and zero the image from out_len (rounded
// down to 16) on.  Lengths out of range stage nothing and zero the image.
__device__ void stage(const uint8_t* comp, int cl, int ol, bool valid, uint8_t* comp_s, uint8_t* out_s) {
  const int nrow = valid ? (cl + 15) / 16 : 0;
  const int zero_from = valid ? ol / 16 : 0;
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < nrow; i += blockDim.x) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(comp_s + 16 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(comp + 16 * i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (threadIdx.x < kSlack / 16) reinterpret_cast<uint4*>(comp_s)[nrow + threadIdx.x] = z;
  for (int i = zero_from + threadIdx.x; i < kBlockSize / 16; i += blockDim.x) reinterpret_cast<uint4*>(out_s)[i] = z;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ void write_back(const uint8_t* out_s, uint8_t* out_row) {
  const uint4* os = reinterpret_cast<const uint4*>(out_s);
  uint4* dst = reinterpret_cast<uint4*>(out_row);
  for (int i = threadIdx.x; i < kBlockSize / 16; i += blockDim.x) dst[i] = os[i];
}

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
  stage(comp + static_cast<size_t>(b) * kPadOut, cl, ol, valid, comp_s, out_s);
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
    const bool good = snappy_pipe::judge_block(w, cl, ol, in, sink);
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
    const bool good = snappy_block::decode_block(comp_s, comp_lens[b], out_lens[b], 0, mv);
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
