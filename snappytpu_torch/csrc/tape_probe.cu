// T3: the tape probe — K5's producer -> mover pipeline with one cost
// changed per mode, to find what sets K5's pace.
//
// Replaces the TPU kernels of tools/tape_probe.py `runner` (`make_kernel`,
// `make_acc_kernel`, `make_rowbatch_kernel`), which time variants of the
// JAX package's tape decoder's movement loop (`_run_tape`) to find what
// serialises it.  Here the tape decoder that ships is K5 (decode_tape.cu
// run_tape_kernel): warp 0 runs decode_tape.cuh's produce_tape (32 records
// a step loaded, checked, converted and handed over as one batch), warp 1
// K2's move_batch.  Every mode keeps that wiring and changes one part
// (anatomy.cuh holds the bodies):
//   full-D1    K5 exactly: the producer loads step s + 1 while it checks and
//              hands over step s (one step in flight), the mover is
//              decode_ring.cuh's mover_loop
//   full-D3    K5 with the producer's loads three steps ahead: steps s + 2
//              and s + 3 on their way by cp.async into a ring in shared
//              memory while step s is handed over (AheadLoad<3>)
//   loads      the producer as K5's; its loads also keep each record's two
//              words in a ring by record index (StashLoad).  The mover takes
//              each batch, folds its tape records into a per-lane word
//              (probe_ref's fold) and releases it, moving nothing
//   const-dst  K5's mover with its plan, groups and __syncwarp, and its
//              reads, but every record lands in the 512-byte scratch beside
//              the image, at its start.  Joining is off and a record writes
//              only the bytes past the longest later record of its batch,
//              so the scratch ends as probe_ref's, the last record's bytes
//              over the earlier ones'; the image is never written, so every
//              read sees the staged image.  The bytes read are folded into a
//              word kept in shared memory, so no read is dropped
//   acc        K5's mover with image rows w and w + 1 (512 bytes each) in a
//              1 KiB window in shared memory: accesses to those rows go to
//              the window, which moves, rows flushed and filled, to the rows
//              of each group's first destination (anatomy.cuh Window).  The
//              TPU kernel kept this window in vector registers to cut
//              dynamic VMEM accesses; on Hopper the image is in shared
//              memory already, so acc measures what staging a window costs
//   rowbatchK  K5's mover with its groups cut every K records (after the
//              join), not at the first record that reads the group's
//              writes: a byte a record reads from an earlier record of its
//              group is resolved by address through those records to its
//              value before the group (anatomy.cuh move_batch_rows), exact
//              on every batch the producer hands over
// The exact modes (full-D1, full-D3, acc, rowbatchK) give K5's rows and
// flags; the plain versions are in snappytpu_torch/tools/tape_probe.py.
//
// Outputs per block: the image's output region (zero for loads and
// const-dst), the ok flag (produce_tape's: 0 <= nrecs <= cap and every
// record inside the image) and 128 auxiliary words: the record fold in
// word 0 (loads), the scratch area (const-dst), zero for the other modes.
//
// What bounds it on the H100: K5's, one serial chain of batches per block,
// one block per SM.  Design: K5's wiring — one thread block of 256 threads
// per block, the 139,776-byte image built in dynamic shared memory with
// 16-byte stores, then 2 KiB beside it (full-D3's load ring, loads' record
// ring, acc's window or const-dst's scratch), then the record ring.

#include <cuda_runtime.h>
#include <stdint.h>

#include "anatomy.cuh"
#include "decode_ring.cuh"
#include "decode_tape.cuh"

namespace {

using snappy_ring::DeviceWarp;
using snappy_ring::Slot;
using snappy_tape::kCompOff;
using snappy_tape::kImageBytes;
using snappy_tape::kOutBase;
using snappy_pipe::Rec;

enum Mode { kFullD1 = 0, kFullD3 = 1, kLoads = 2, kConstDst = 3, kAcc = 4, kRowBatch = 5 };  // tape_probe.py

constexpr int kThreads = 256;
constexpr int kExtra = 2048;  // beside the image: full-D3's ring (768 B), loads' (2 KiB), acc's window, the scratch
constexpr int kScratch = 512;
constexpr int kAux = 128;  // auxiliary words per block
constexpr size_t kSmem = kImageBytes + kExtra + snappy_ring::kSlots * sizeof(Slot);
static_assert(kImageBytes % 512 == 0 && kCompOff % 16 == 0 && kOutBase % 16 == 0, "rows of 512, 16-byte staging");
static_assert(8 * snappy_anat::kStash <= kExtra && kScratch + 4 * 32 <= kExtra, "what lies beside the image");

// K5's record loads (decode_tape.cu TapeLoad): lane l gets record r + l's
// two words, zeros past nrecs.
struct PairLoad {
  const int32_t* tape;
  int32_t nrecs;
  __host__ __device__ void operator()(DeviceWarp& w, int32_t r, DeviceWarp::Var<int32_t>& w0,
                                      DeviceWarp::Var<int32_t>& w1) const {
    const int32_t i = r + w.lane;
    w0.v = w1.v = 0;
    if (i < nrecs) snappy_anat::load_pair(tape + 2 * i, w0.v, w1.v);
  }
};

template <int M, int K>
__device__ void move_all(Slot* ring, int lane, uint8_t* img, uint32_t* fold) {
  DeviceWarp w{lane};
  uint8_t* extra = img + kImageBytes;
  snappy_anat::Covered scratch{img};
  snappy_anat::Window win{img, extra, static_cast<int32_t>(kImageBytes / 512), 0};
  if constexpr (M == kAcc) win.load(w, static_cast<int32_t>(kOutBase / 512));
  uint32_t acc = 0;
  int32_t taken = 0;
  for (int f = 0;; ++f) {
    Slot& slot = ring[f % snappy_ring::kSlots];
    snappy_ring::bar_sync(snappy_ring::full_bar(f % snappy_ring::kSlots));
    const int n = slot.n;
    const bool last = slot.last;
    DeviceWarp::Var<Rec> rec{lane < n ? slot.recs[lane] : Rec{0, 0, 0, 0}};
    if constexpr (M == kLoads) acc ^= snappy_anat::fold_stashed(reinterpret_cast<const int32_t*>(extra), taken, n, lane);
    snappy_ring::bar_arrive(snappy_ring::empty_bar(f % snappy_ring::kSlots));
    taken += n;
    if constexpr (M == kConstDst)
      snappy_anat::move_batch_as(w, rec, n, false, snappy_anat::ScratchPlace{static_cast<int32_t>(kImageBytes)},
                                 scratch);
    if constexpr (M == kAcc) snappy_anat::move_batch_as(w, rec, n, true, snappy_anat::ImagePlace{}, win);
    if constexpr (M == kRowBatch) {
      snappy_anat::Plain plain{img};
      snappy_anat::move_batch_rows<K>(w, rec, n, plain);
    }
    if (last) break;
  }
  if constexpr (M == kAcc) win.flush(w);
  if constexpr (M == kConstDst) reinterpret_cast<uint32_t*>(extra + kScratch)[lane] = scratch.acc;  // keeps the reads
  *fold = acc;
}

template <int M, int K>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const int32_t* __restrict__ tapes, const int32_t* __restrict__ nrecs,
             const uint8_t* __restrict__ comp, uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
             int32_t* __restrict__ aux, int cap) {
  extern __shared__ __align__(16) uint8_t img[];
  __shared__ int ok_s;
  __shared__ uint32_t fold_s;
  Slot* ring = reinterpret_cast<Slot*>(img + kImageBytes + kExtra);
  const int b = blockIdx.x;
  uint4* im = reinterpret_cast<uint4*>(img);
  const uint4* row = reinterpret_cast<const uint4*>(comp + static_cast<size_t>(b) * snappy_block::kPadOut);
  for (int i = threadIdx.x; i < (kImageBytes + kExtra) / 16; i += blockDim.x) {
    const bool in_comp = i >= kCompOff / 16 && i < kOutBase / 16;
    im[i] = in_comp ? row[i - kCompOff / 16] : make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) ok_s = 0, fold_s = 0;
  __syncthreads();

  const int32_t nr = nrecs[b];
  const int32_t* tape = tapes + 2 * static_cast<size_t>(b) * cap;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (0 <= nr && nr <= cap && warp == 0) {
    DeviceWarp w{lane};
    snappy_ring::RingSink sink{ring, lane};
    sink.open();
    bool good;
    if constexpr (M == kFullD3) {
      snappy_anat::AheadLoad<3> load{tape, nr, reinterpret_cast<int32_t*>(img + kImageBytes)};
      good = snappy_tape::produce_tape(w, nr, load, sink);
      load.drain();
    } else if constexpr (M == kLoads) {
      snappy_anat::StashLoad load{tape, nr, reinterpret_cast<int32_t*>(img + kImageBytes)};
      good = snappy_tape::produce_tape(w, nr, load, sink);
    } else {
      PairLoad load{tape, nr};
      good = snappy_tape::produce_tape(w, nr, load, sink);
    }
    if (lane == 0) ok_s = good;
  } else if (0 <= nr && nr <= cap && warp == 1) {
    if constexpr (M == kFullD1 || M == kFullD3) {
      snappy_ring::mover_loop(ring, lane, img, img);
    } else {
      uint32_t acc;
      move_all<M, K>(ring, lane, img, &acc);
      for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xFFFFFFFFu, acc, o);
      if (lane == 0) fold_s = acc;
    }
  }
  __syncthreads();

  snappy_ring::write_back(img + kOutBase, out + static_cast<size_t>(b) * snappy_block::kBlockSize);
  const int32_t* scr = reinterpret_cast<const int32_t*>(img + kImageBytes);
  for (int i = threadIdx.x; i < kAux; i += blockDim.x)
    aux[static_cast<size_t>(b) * kAux + i] =
        M == kConstDst ? scr[i] : (M == kLoads && i == 0 ? static_cast<int32_t>(fold_s) : 0);
  if (threadIdx.x == 0) ok[b] = ok_s ? 1 : 0;
}

template <int M, int K>
int launch(const void* tapes, const void* nrecs, const void* comp, void* out, void* ok, void* aux, int B, int cap,
           cudaStream_t stream) {
  cudaError_t err = snappy_ring::allow_smem(probe_kernel<M, K>, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_kernel<M, K><<<B, kThreads, kSmem, stream>>>(
      static_cast<const int32_t*>(tapes), static_cast<const int32_t*>(nrecs), static_cast<const uint8_t*>(comp),
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok), static_cast<int32_t*>(aux), cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 full-D1, 1 full-D3, 2 loads, 3 const-dst, 4 acc, 5 rowbatchK with K = k in {2, 4, 8}
// (tools/tape_probe.py MODES).  tapes: (B, cap) records of two int32 words.
extern "C" int snappy_tape_probe(const void* tapes, const void* nrecs, const void* comp, void* out, void* ok,
                                 void* aux, int B, int cap, int mode, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFullD1: return launch<kFullD1, 0>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
    case kFullD3: return launch<kFullD3, 0>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
    case kLoads: return launch<kLoads, 0>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
    case kConstDst: return launch<kConstDst, 0>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
    case kAcc: return launch<kAcc, 0>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
    case kRowBatch:
      switch (k) {
        case 2: return launch<kRowBatch, 2>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
        case 4: return launch<kRowBatch, 4>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
        case 8: return launch<kRowBatch, 8>(tapes, nrecs, comp, out, ok, aux, B, cap, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
