// T2: the decode anatomy probe — K2's sizer -> judge -> mover pipeline with
// its mover warp swapped per variant, to split K2's time.
//
// Replaces the TPU kernel of tools/dec_anatomy.py `decode` (the kernels of
// `make_decoder(variant)`), which times stripped variants of the JAX
// package's shipping block decoder (the v2 piece loop with decode_vm4's
// `_parse_at`) to split its serial chain into parse, window read, merge and
// dynamic addressing.  Here the decoder that ships is K2
// (decode_block.cu decode_blocks_kernel), and each variant is K2 with only
// its mover warp changed (anatomy.cuh):
//   parse   the mover takes each batch, notes where its last record ends
//           and releases it; it moves nothing.  parse is the sizer, the
//           judge and the hand-over with an idle mover
//   window  move_batch's plan, groups and __syncwarp, and its reads (a
//           literal's bytes from the staged row, a copy's from the image,
//           which stays zero), each byte folded into a per-lane word at its
//           destination's byte lane; nothing is written.  window − parse is
//           the mover's reads and group syncs
//   full    K2's move_batch exactly: the real decode.  full − window is its
//           writes
//   fixed   K2's reads and writes with every op's source at compressed
//           byte 64 on (j, or j % dist for a copy that reads its own
//           output) and its destination at image byte 0 on, folded like
//           window.  Every op writes the same bytes and the result is the
//           last op's, as `_walk` defines it: joining is off (a joined run
//           would index j % dist across ops), and a record writes only the
//           bytes past the longest later record of its batch, so each byte
//           is written once per batch, by the last op that covers it; the
//           groups are cut where K2 cuts them, on the real addresses.
//           full − fixed is the cost of moving addresses, together with
//           what joining saves K2 (fixed moves every op of a run of copies
//           at one distance, where full moves one record) and the writes
//           the cover drops
// The mover also notes where the last record of the last batch ends, the
// final output cursor (the TPU tool's ok tile holds the same `opc`).
//
// Outputs per block, defined for every variant and computed exactly by the
// plain walk (snappytpu_torch/tools/dec_anatomy.py `walk_ref`): the output
// image (zero for parse and window, the decoded row for full, the fixed
// area for fixed), K2's ok flag, the final cursor, and the fold: the XOR
// over the lanes of each byte read at byte lane (destination & 3), that is
// the XOR of the little-endian words the bytes read would form at their
// destinations (0 for parse and full).
//
// What bounds it on the H100: K2's, the serial op chain, one block per SM.
// Design: K2's wiring — one thread block of 256 threads per 64 KiB block;
// the row's comp_len bytes (rounded up to 16) staged by cp.async with
// kSlack zero bytes after them; the two decode_ring.cuh rings and their
// named barriers; warp 0 sizes, warp 1 judges, warp 2 moves, the other
// warps help stage and write back.  Two departures from K2's staging, both
// a few microseconds a batch: the whole image is zeroed, not only
// [out_len, 65536), so that a block that is not ok is zero where no op
// wrote (window reads zeros there too); and fixed stages the row up to
// byte 64 + out_len, which its ops read, where that lies past comp_len.

#include <cuda_runtime.h>
#include <stdint.h>

#include "anatomy.cuh"
#include "decode_pipe.cuh"
#include "decode_ring.cuh"

namespace {

using namespace snappy_ring;  // decode_ring.cuh: the warp policy, the rings, stage, write_back

enum Variant { kParse = 0, kWindow = 1, kFull = 2, kFixed = 3 };  // tools/dec_anatomy.py VARIANTS

constexpr int kThreads = 256;
constexpr size_t kSmem = kRowBytes + kBlockSize + kSlots * sizeof(Slot) + kWinSlots * sizeof(WinSlot);  // K2's
constexpr int32_t kOut = static_cast<int32_t>(kRowBytes);  // the image's offset from the staged row
static_assert(kRowBytes % 16 == 0, "the image is 16-byte aligned after the row");

// The mover warp of variant V: decode_ring.cuh's mover_loop with the batch
// mover swapped.  Returns the final cursor; *acc gets the lane's fold.
template <int V>
__device__ int32_t mover(Slot* ring, int lane, uint8_t* smem, uint32_t* acc) {
  DeviceWarp w{lane};
  snappy_anat::Fold fold{smem};
  snappy_anat::Covered fixed{smem};
  int32_t end = 0;
  for (int f = 0;; ++f) {
    Slot& slot = ring[f % kSlots];
    bar_sync(full_bar(f % kSlots));
    const int n = slot.n;
    const bool last = slot.last;
    DeviceWarp::Var<Rec> rec{lane < n ? slot.recs[lane] : Rec{0, 0, 0, 0}};
    bar_arrive(empty_bar(f % kSlots));
    end = snappy_anat::batch_end(w, rec, n, end);
    if constexpr (V == kWindow) snappy_anat::move_batch_as(w, rec, n, true, snappy_anat::K2Place{0, kOut}, fold);
    if constexpr (V == kFull) snappy_pipe::move_batch(w, rec, n, smem, smem + kOut);
    if constexpr (V == kFixed) snappy_anat::move_batch_as(w, rec, n, false, snappy_anat::FixedPlace{0, kOut}, fixed);
    if (last) break;
  }
  *acc = V == kWindow ? fold.acc : (V == kFixed ? fixed.acc : 0u);
  return end;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
anatomy_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_lens,
               const int32_t* __restrict__ out_lens, uint8_t* __restrict__ out, uint8_t* __restrict__ ok,
               int32_t* __restrict__ opc, int32_t* __restrict__ fold) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ok_s, halt_s, end_s;
  __shared__ uint32_t fold_s;
  uint8_t* comp_s = smem;
  uint8_t* out_s = smem + kRowBytes;
  Slot* ring = reinterpret_cast<Slot*>(smem + kRowBytes + kBlockSize);
  WinSlot* windows = reinterpret_cast<WinSlot*>(smem + kRowBytes + kBlockSize + kSlots * sizeof(Slot));
  const int b = blockIdx.x;
  const int cl = comp_lens[b], ol = out_lens[b];
  const bool valid = 0 <= cl && cl <= kPadOut && 0 <= ol && ol <= kBlockSize;
  int nrow = valid ? (cl + 15) / 16 : 0;
  if (V == kFixed && valid && nrow < (snappy_anat::kFixedSrc + ol + 15) / 16)
    nrow = (snappy_anat::kFixedSrc + ol + 15) / 16;  // <= (64 + 65536 + 15) / 16 < kPadOut / 16
  stage(comp + static_cast<size_t>(b) * kPadOut, nrow, comp_s, out_s, 0, kBlockSize / 16);
  if (threadIdx.x == 0) ok_s = halt_s = end_s = 0, fold_s = 0;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (valid && warp == 0) {
    DeviceWarp w{lane};
    WinOut o{windows, &halt_s, lane};
    snappy_pipe::size_block(w, comp_s, cl, o);
  } else if (valid && warp == 1) {
    DeviceWarp w{lane};
    WinIn in{windows, &halt_s, lane};
    RingSink sink{ring, lane};
    sink.open();
    const bool good = snappy_pipe::judge_block(w, cl, ol, 0, in, sink);
    if (lane == 0) ok_s = good;
  } else if (valid && warp == 2) {
    uint32_t acc;
    const int32_t end = mover<V>(ring, lane, smem, &acc);
    for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xFFFFFFFFu, acc, o);
    if (lane == 0) {
      end_s = end;
      fold_s = acc;
    }
  }
  __syncthreads();

  write_back(out_s, out + static_cast<size_t>(b) * kBlockSize);
  if (threadIdx.x == 0) {
    ok[b] = ok_s ? 1 : 0;
    opc[b] = end_s;
    fold[b] = static_cast<int32_t>(fold_s);
  }
}

template <int V>
int launch(const void* comp, const void* comp_lens, const void* out_lens, void* out, void* ok, void* opc,
           void* fold, int B, cudaStream_t stream) {
  cudaError_t err = allow_smem(anatomy_kernel<V>, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  anatomy_kernel<V><<<B, kThreads, kSmem, stream>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_lens),
      static_cast<const int32_t*>(out_lens), static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok),
      static_cast<int32_t*>(opc), static_cast<int32_t*>(fold));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 parse, 1 window, 2 full, 3 fixed (tools/dec_anatomy.py VARIANTS).
extern "C" int snappy_dec_anatomy(const void* comp, const void* comp_lens, const void* out_lens, void* out,
                                  void* ok, void* opc, void* fold, int B, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kParse: return launch<kParse>(comp, comp_lens, out_lens, out, ok, opc, fold, B, s);
    case kWindow: return launch<kWindow>(comp, comp_lens, out_lens, out, ok, opc, fold, B, s);
    case kFull: return launch<kFull>(comp, comp_lens, out_lens, out, ok, opc, fold, B, s);
    case kFixed: return launch<kFixed>(comp, comp_lens, out_lens, out, ok, opc, fold, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
