// The device side of decode_pipe.cuh's warps, shared by K2 (decode_block.cu),
// K4 (decode_stream.cu) and K5 (decode_tape.cu): the warp policy, the two
// rings that hand work from one warp to another through shared memory, the
// mover's loop, and the staging and write-back of a block.
//
// A hand-over costs one pair of named barriers (bar.arrive by the producer,
// bar.sync by the consumer, 64 threads) per window or batch: FULL(s) says
// slot s is filled, EMPTY(s) that its consumer has taken it.  Each producer
// takes back its consumer's last EMPTYs when it ends, so no barrier is left
// half arrived; a judge that ends a block early raises a flag and drains the
// sizer's windows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_pipe.cuh"

namespace snappy_ring {

using snappy_block::kBlockSize;
using snappy_block::kPadOut;
using snappy_pipe::kBatch;
using snappy_pipe::kSlack;
using snappy_pipe::Rec;

constexpr int kSlots = 3;     // record batches in flight, producer -> mover
constexpr int kWinSlots = 4;  // windows in flight, sizer -> judge
constexpr int kPair = 64;     // threads at a named barrier: the two warps of a ring
constexpr size_t kRowBytes = kPadOut + kSlack;  // a staged compressed row

struct Slot {
  Rec recs[kBatch];
  int n;     // records in the batch
  int last;  // the producer ended with this batch
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
// Its methods, and the rings', are __host__ __device__ only so that
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

// The producer's end of the record ring (K2's judge, K5's tape producer):
// batch f goes to slot f % kSlots, which the producer first waits to be
// empty once the mover has had it.  open() before the first room().
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

// The mover warp: takes the batches in order and moves each with
// decode_pipe.cuh's move_batch, until the last.
__device__ inline void mover_loop(Slot* ring, int lane, const uint8_t* comp_s, uint8_t* out_s) {
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

// Stage a row's first nrow 16-byte pieces by cp.async with kSlack zero bytes
// after them, zero the 16-byte words [zero_from, zero_to) of out_s while
// the copies run, then wait for them.  All threads of the block call it.
__device__ inline void stage(const uint8_t* comp, int nrow, uint8_t* comp_s, uint8_t* out_s, int zero_from,
                             int zero_to) {
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < nrow; i += blockDim.x) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(comp_s + 16 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(comp + 16 * i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (threadIdx.x < kSlack / 16) reinterpret_cast<uint4*>(comp_s)[nrow + threadIdx.x] = z;
  for (int i = zero_from + threadIdx.x; i < zero_to; i += blockDim.x) reinterpret_cast<uint4*>(out_s)[i] = z;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Write a 64 KiB output image to its row with 16-byte stores.
__device__ inline void write_back(const uint8_t* out_s, uint8_t* out_row) {
  const uint4* os = reinterpret_cast<const uint4*>(out_s);
  uint4* dst = reinterpret_cast<uint4*>(out_row);
  for (int i = threadIdx.x; i < kBlockSize / 16; i += blockDim.x) dst[i] = os[i];
}

}  // namespace snappy_ring
