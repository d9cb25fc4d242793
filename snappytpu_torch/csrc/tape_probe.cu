// T3: the tape probe — the record-by-record walk (K5's until K5 moved onto
// K2's grouped mover, K6's until K6 moved onto the byte-source resolver,
// which keeps it for out-of-order tapes; decode_tape.cu), one cost changed
// per mode.
//
// Replaces the TPU kernels of tools/tape_probe.py `runner` (`make_kernel`,
// `make_acc_kernel`, `make_rowbatch_kernel`), which time variants of the
// tape decoder's movement loop to find what serialises it.  Every mode here
// is snappy_tape::run_tape (decode_tape.cuh, unchanged: it validates each
// record and stops at the first one outside the image) with another fetch or
// move functor beside K6's WarpFetch / WarpMove:
//   full-D1    K6 exactly: the 32 lanes load 32 records at once when the walk
//              reaches a multiple of 32, and each record is broadcast by
//              __shfl_sync; so the walk waits on global memory once a group
//   full-D3    groups g, g+1 and g+2 are loaded ahead into a ring in shared
//              memory by cp.async, the load of group g+2 issued when group
//              g starts, so a group boundary never waits on global memory
//              (record load-ahead; see AheadFetch)
//   loads      fetch and loop only: no byte moves and no __syncwarp; every
//              record is folded into one word, written once per block
//   const-dst  K6's reads and a __syncwarp per record, but every record's
//              bytes land at one fixed destination: a 512-byte scratch area
//              beside the image.  The image is never written, so every read
//              sees the staged image and every lane writes its own bytes
//              (lane l owns scratch bytes l, l + 32, ...): the result, the
//              scratch area after the last record, is the same in any lane
//              order, though a copy's source may overlap the fixed
//              destination's image address (no record reads the scratch)
//   acc        the write window is staged: image rows w and w+1 (512 bytes
//              each) live in a 1 KiB shared buffer; writes go there, reads
//              of those rows are taken from it, and when a record's
//              destination row moves past w the rows that leave are flushed
//              to the image and the rows that enter are loaded (one 16-byte
//              store and load per lane each); the rest of the image is read
//              in place.  The TPU kernel kept this window in vector
//              registers to cut dynamic VMEM accesses; on Hopper registers
//              cannot be indexed by a byte address, so the counterpart
//              stages it in shared memory
//   rowbatchK  K records per warp step with one __syncwarp.  A record may
//              read bytes that an earlier record of the same step wrote, and
//              without a __syncwarp another lane's write is not visible; so
//              each lane resolves every source byte through the step's
//              earlier records (a byte inside record m's destination is
//              record m's source byte at the same offset, then through
//              m - 1 ... 0) and reads the image as it was before the step.
//              That is the TPU kernel's substitution from the pending tile,
//              done by address.  It is exact when no record of the step
//              writes a byte that an earlier record of the step reads or
//              writes; a step where one does (never on the builder's tapes,
//              whose destinations advance and are written once) runs record
//              by record with a __syncwarp each, as K6.
// full-D1, full-D3, acc and rowbatchK move every accepted record's bytes as
// K6 does and give K6's (and K5's) bytes and flags exactly: decode_tape.cuh's argument
// (a copy never overlaps its own destination, a fill reads only the p bytes
// before it) makes each record's bytes the same in any lane order, and the
// staging (acc) and the resolution (rowbatchK) give every read the value the
// record-by-record walk reads.  The plain versions are in
// snappytpu_torch/tools/tape_probe.py.
//
// Outputs per block: the image's output region, the ok flag (run_tape's:
// 0 <= nrecs <= cap and every record inside the image) and 128 auxiliary
// words: the record fold in word 0 (loads), the scratch area (const-dst),
// zero for the other modes.
//
// What bounds it on the H100: K6's, one serial chain of records per block,
// one block per SM.  Design: K6's shape — one thread block of 256 threads per
// block, the 139,776-byte image (plus 1 KiB of window or scratch) in dynamic
// shared memory, warp 0 walks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_tape.cuh"

namespace {

using snappy_tape::kCompOff;
using snappy_tape::kImageBytes;
using snappy_tape::kOutBase;
using snappy_tape::Record;

constexpr int kThreads = 256;
constexpr int kExtra = 1024;  // acc's window, const-dst's scratch (512 B) or full-D3's ring (768 B)
constexpr size_t kSmemBytes = kImageBytes + kExtra;
constexpr int64_t kRows = kImageBytes / 512;  // 273 image rows of 512 bytes
constexpr int kAux = 128;                     // auxiliary words per block
static_assert(kImageBytes % 512 == 0 && kOutBase % 512 == 0, "rows of 512 bytes");

// ---- fetches ----

// Groups of 32 records through a ring of D groups in shared memory, filled
// by cp.async (global to shared without passing through registers, so
// issuing a load never waits for it).  When the walk starts group g, each
// lane issues its record of group g + D - 1 into the slot group g - 1 has
// left, then waits until no more than D - 1 groups are in flight, which
// leaves group g complete, and takes its record of group g into a register;
// record r is then shuffled from lane r % 32 as in WarpFetch.  Each lane
// copies and reads only its own slot entries, so no __syncwarp is needed.
// (A ring of registers does not do it: the compiler's register rotation
// reads the loaded register as soon as the load is issued.)
template <int D>
struct AheadFetch {
  const int2* tape;
  int64_t nrecs;
  int lane;
  int2 held;
  int2* ring;  // D * 32 records in shared memory

  __device__ void issue(int64_t g) {
    const int64_t i = 32 * g + lane;
    if (i < nrecs) {
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(ring + (g % D) * 32 + lane));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(tape + i) : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ void init(int2* slots) {
    ring = slots;
#pragma unroll
    for (int g = 0; g + 1 < D; ++g) issue(g);
  }

  __host__ __device__ Record operator()(int64_t r) {
#ifdef __CUDA_ARCH__
    if ((r & 31) == 0) {
      const int64_t g = r >> 5;
      issue(g + D - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(D - 1) : "memory");
      held = ring[(g % D) * 32 + lane];
    }
    const int k = static_cast<int>(r & 31);
    return snappy_tape::decode_record(__shfl_sync(0xFFFFFFFFu, held.x, k), __shfl_sync(0xFFFFFFFFu, held.y, k));
#else
    return Record{};
#endif
  }
};

// ---- moves: operator() per accepted record, then finish(), then aux() ----

struct FullMove : snappy_tape::WarpMove {
  uint8_t* extra;
  __device__ void init() {}
  __device__ void finish() {}
  __device__ void aux(int32_t* row) const {
    for (int i = lane; i < kAux; i += 32) row[i] = 0;
  }
};

// The fold of one record (tools/tape_probe.py `_fold`).
__device__ __forceinline__ uint32_t fold_record(const Record& r) {
  return static_cast<uint32_t>(r.src) ^ (static_cast<uint32_t>(r.dst) << 4) ^ (static_cast<uint32_t>(r.len) << 20) ^
         (static_cast<uint32_t>(r.period) << 28);
}

struct LoadsMove {
  uint8_t* img;
  int lane;
  uint8_t* extra;
  uint32_t acc = 0;

  __device__ void init() {}
  __host__ __device__ void operator()(const Record& r) {
#ifdef __CUDA_ARCH__
    acc ^= fold_record(r);
#endif
  }
  __device__ void finish() {}
  __device__ void aux(int32_t* row) const {
    for (int i = lane; i < kAux; i += 32) row[i] = i == 0 ? static_cast<int32_t>(acc) : 0;
  }
};

struct ConstDstMove {
  uint8_t* img;
  int lane;
  uint8_t* extra;  // the scratch area: the first 512 bytes beside the image

  __device__ void init() {}
  __host__ __device__ void operator()(const Record& r) {
#ifdef __CUDA_ARCH__
    const int len = static_cast<int>(r.len);
    if (r.period == 0) {
      const int src = static_cast<int>(r.src);
      for (int j = lane; j < len; j += 32) extra[j] = img[src + j];
    } else {
      const int p = static_cast<int>(r.period);
      const int from = static_cast<int>(r.dst) - p;
      for (int j = lane; j < len; j += 32) extra[j] = img[from + (j & (p - 1))];
    }
    __syncwarp();
#endif
  }
  __device__ void finish() {}
  __device__ void aux(int32_t* row) const {
    const int32_t* w = reinterpret_cast<const int32_t*>(extra);
    for (int i = lane; i < kAux; i += 32) row[i] = w[i];
  }
};

struct AccMove {
  uint8_t* img;
  int lane;
  uint8_t* extra;  // the window, 1 KiB beside the image: image row r in slot r & 1
  int64_t w = kOutBase / 512;

  __device__ bool held(int64_t row) const { return row == w || row == w + 1; }
  __device__ uint8_t read(int64_t a) const { return held(a >> 9) ? extra[a & 1023] : img[a]; }
  __device__ void flush(int64_t row) {
    if (row < kRows)
      reinterpret_cast<uint4*>(img + row * 512)[lane] = reinterpret_cast<const uint4*>(extra + (row & 1) * 512)[lane];
  }
  __device__ void fill(int64_t row) {
    if (row < kRows)
      reinterpret_cast<uint4*>(extra + (row & 1) * 512)[lane] = reinterpret_cast<const uint4*>(img + row * 512)[lane];
  }

  __device__ void init() {
    fill(w);
    fill(w + 1);
    __syncwarp();
  }

  __host__ __device__ void operator()(const Record& r) {
#ifdef __CUDA_ARCH__
    const int64_t row = r.dst >> 9;
    if (row != w) {  // the same record on every lane: a uniform branch
      for (int64_t o = w; o <= w + 1; ++o)
        if (o != row && o != row + 1) flush(o);
      for (int64_t n = row; n <= row + 1; ++n)
        if (!held(n)) fill(n);
      w = row;
      __syncwarp();
    }
    const int len = static_cast<int>(r.len);
    const int64_t dst = r.dst;
    if (r.period == 0) {
      for (int j = lane; j < len; j += 32) extra[(dst + j) & 1023] = read(r.src + j);
    } else {
      const int p = static_cast<int>(r.period);
      for (int j = lane; j < len; j += 32) extra[(dst + j) & 1023] = read(dst - p + (j & (p - 1)));
    }
    __syncwarp();
#endif
  }

  __device__ void finish() {
    flush(w);
    flush(w + 1);
    __syncwarp();
  }
  __device__ void aux(int32_t* row) const {
    for (int i = lane; i < kAux; i += 32) row[i] = 0;
  }
};

template <int K>
struct RowBatchMove {
  uint8_t* img;
  int lane;
  uint8_t* extra;
  Record rec[K];
  int n = 0;

  __device__ void init() {}

  __host__ __device__ void operator()(const Record& r) {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i == n) rec[i] = r;
    if (++n == K) step();
#endif
  }

  __device__ void finish() {
    if (n > 0) step();
  }

  __device__ void aux(int32_t* row) const {
    for (int i = lane; i < kAux; i += 32) row[i] = 0;
  }

  // Source range of record i: [lo, hi).
  __device__ static int64_t src_lo(const Record& r) { return r.period ? r.dst - r.period : r.src; }
  __device__ static int64_t src_hi(const Record& r) { return r.period ? r.dst : r.src + r.len; }
  __device__ static bool meets(int64_t lo, int64_t hi, int64_t lo2, int64_t hi2) { return lo < hi2 && lo2 < hi; }

  // Records 0..n-1 of the step; n is the same on every lane.
  __device__ void step() {
    bool hazard = false;
#pragma unroll
    for (int b = 1; b < K; ++b)
#pragma unroll
      for (int a = 0; a < b; ++a)
        if (b < n)
          hazard |= meets(rec[b].dst, rec[b].dst + rec[b].len, rec[a].dst, rec[a].dst + rec[a].len) ||
                    meets(rec[b].dst, rec[b].dst + rec[b].len, src_lo(rec[a]), src_hi(rec[a]));
    if (hazard) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k < n) {
          snappy_tape::lane_move(img, rec[k], lane);
          __syncwarp();
        }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k >= n) break;
        const int len = static_cast<int>(rec[k].len);
        for (int j = lane; j < len; j += 32) {
          int64_t a = rec[k].period ? rec[k].dst - rec[k].period + (j & (rec[k].period - 1)) : rec[k].src + j;
#pragma unroll
          for (int m = K - 2; m >= 0; --m) {
            if (m < k && a >= rec[m].dst && a < rec[m].dst + rec[m].len) {
              const int64_t o = a - rec[m].dst;
              a = rec[m].period ? rec[m].dst - rec[m].period + (o & (rec[m].period - 1)) : rec[m].src + o;
            }
          }
          img[rec[k].dst + j] = img[a];
        }
      }
      __syncwarp();
    }
    n = 0;
  }
};

// ---- the kernel ----

__device__ void init_fetch(snappy_tape::WarpFetch&, uint8_t*) {}
template <int D>
__device__ void init_fetch(AheadFetch<D>& f, uint8_t* ring) {
  f.init(reinterpret_cast<int2*>(ring));
}

// No cp.async of the walk outlives it (the last groups may run past nrecs).
__device__ void drain_fetch(snappy_tape::WarpFetch&) {}
template <int D>
__device__ void drain_fetch(AheadFetch<D>&) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <class Fetch, class Move>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const int32_t* __restrict__ tapes, const int32_t* __restrict__ nrecs,
             const uint8_t* __restrict__ comp, uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
             int32_t* __restrict__ aux, int cap) {
  extern __shared__ __align__(16) uint8_t img[];
  __shared__ int ok_s;
  const int b = blockIdx.x;

  uint4* im = reinterpret_cast<uint4*>(img);
  const uint4* src = reinterpret_cast<const uint4*>(comp + static_cast<size_t>(b) * snappy_block::kPadOut);
  for (int i = threadIdx.x; i < static_cast<int>(kSmemBytes / 16); i += blockDim.x) {
    const bool in_comp = i >= kCompOff / 16 && i < kOutBase / 16;
    im[i] = in_comp ? src[i - kCompOff / 16] : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = static_cast<int>(threadIdx.x);
    const int64_t nr = nrecs[b];
    Fetch fetch{};
    fetch.tape = reinterpret_cast<const int2*>(tapes) + static_cast<size_t>(b) * cap;
    fetch.nrecs = nr;
    fetch.lane = lane;
    if (0 <= nr && nr <= cap) init_fetch(fetch, img + kImageBytes);  // run_tape reads no record otherwise
    Move move{};
    move.img = img;
    move.lane = lane;
    move.extra = img + kImageBytes;
    move.init();
    const bool good = snappy_tape::run_tape(nr, cap, fetch, move);
    drain_fetch(fetch);
    move.finish();
    move.aux(aux + static_cast<size_t>(b) * kAux);
    if (lane == 0) ok_s = good;
  }
  __syncthreads();

  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * snappy_block::kBlockSize);
  for (int i = threadIdx.x; i < snappy_block::kBlockSize / 16; i += blockDim.x) dst[i] = im[kOutBase / 16 + i];
  if (threadIdx.x == 0) ok[b] = ok_s ? 1 : 0;
}

template <class Fetch, class Move>
int launch(const void* tapes, const void* nrecs, const void* comp, void* out, void* ok, void* aux, int B, int cap,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(probe_kernel<Fetch, Move>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_kernel<Fetch, Move><<<B, kThreads, kSmemBytes, stream>>>(
      static_cast<const int32_t*>(tapes), static_cast<const int32_t*>(nrecs), static_cast<const uint8_t*>(comp),
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok), static_cast<int32_t*>(aux), cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 full-D1, 1 full-D3, 2 loads, 3 const-dst, 4 acc, 5 rowbatchK with K = k in {2, 4, 8}
// (tools/tape_probe.py MODES).  tapes: (B, cap) records of two int32 words.
extern "C" int snappy_tape_probe(const void* tapes, const void* nrecs, const void* comp, void* out, void* ok,
                                 void* aux, int B, int cap, int mode, int k, void* stream) {
  using snappy_tape::WarpFetch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<WarpFetch, FullMove>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
    case 1: return launch<AheadFetch<3>, FullMove>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
    case 2: return launch<WarpFetch, LoadsMove>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
    case 3: return launch<WarpFetch, ConstDstMove>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
    case 4: return launch<WarpFetch, AccMove>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
    case 5:
      switch (k) {
        case 2: return launch<WarpFetch, RowBatchMove<2>>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
        case 4: return launch<WarpFetch, RowBatchMove<4>>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
        case 8: return launch<WarpFetch, RowBatchMove<8>>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
