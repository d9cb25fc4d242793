// K7: tier B of the encoder's match finder, one thread block per 64 KiB block.
//
// Replaces no TPU kernel: the JAX encoder's tier B (snappytpu/kernels/
// encode_v2.py `_find_matches`) is array code, a multi-key lax.sort of the
// carried key words, their gathers and the neighbour LCPs, and the port's
// torch chain (encode_v2._tier_b, the CPU route and what the tests hold K7
// to) did the same with 8 (dense) or 3 (fast) stable radix sorts over int64
// words, the 16 carried words gathered into sorted order and ~100 elementwise
// ops over them: about 2 GB moved for a 128-block call.  What it computes is
// in tier_b.cuh.
//
// What bounds it on the H100: the comparisons of the sort, and not bytes: a
// block reads 64 KiB and writes two int32 a position.  So a block's bytes,
// staged as big-endian words, and its order (a uint16 a position: 128 KiB
// dense, 32 KiB fast, padded by 4 KiB) live in shared memory (200,768 bytes
// dense), and a key is read from the bytes where a comparison needs it,
// never stored.  A merge level cannot merge in place and a second order
// does not fit beside the first, so each level writes its output to a
// scratch row in device memory (L2-resident: 16 MiB for 128 dense blocks)
// and the block copies it back after a barrier.  Written where each thread
// merges its own share, 64 entries apart from its neighbours', a warp's
// 2-byte stores touched 32 sectors each and the merge spent 2.1 of its 2.7
// ms a dense call of 128 blocks on them; so the scratch row holds the
// lanes' j-th outputs side by side, and the order in shared memory pads
// each share so that the lanes' entries fall in distinct banks
// (tier_b.cuh's order_index and scratch_index).  One block of 1024 threads
// an SM: a 128-block call fills 128 of the 132 SMs.
//
// The launch takes its stream, allocates nothing (the wrapper gives the
// scratch and the outputs) and never synchronises, so it records into the
// encoder's CUDA graph as any launch does.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tier_b.cuh"

namespace {

using namespace snappy_tier_b;

// A thread's merge outputs, to the block's scratch row at scratch_index
// (not through L1: the row is written and read back within the level).
// __host__ __device__ only so that tier_b.cuh's __host__ __device__
// template instantiates; the host side is never called.
struct ScratchStore {
  uint16_t* row;
  int32_t shift;
  __host__ __device__ void operator()(int32_t k, int32_t q) const {
#ifdef __CUDA_ARCH__
    __stcg(row + scratch_index(k, shift), static_cast<unsigned short>(q));
#else
    (void)k;
    (void)q;
#endif
  }
};

__global__ void __launch_bounds__(kThreads, 1)
tier_b_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ lens, uint16_t* __restrict__ scratch,
              int32_t* __restrict__ out_len, int32_t* __restrict__ out_dist, const Params P) {
  extern __shared__ uint4 smem4[];
  uint32_t* T = reinterpret_cast<uint32_t*>(smem4);               // kTextWords: the block, big-endian, zeros after
  uint16_t* pad = reinterpret_cast<uint16_t*>(T + kTextWords);    // the order at order_index
  const int32_t t = threadIdx.x, b = blockIdx.x, N = kBlock / P.stride, n = lens[b];
  const int32_t share = N / kThreads, shift = 31 - __clz(share);
  const uint4* row = reinterpret_cast<const uint4*>(blocks + static_cast<size_t>(b) * kBlock);
  for (int32_t i = t; i < kBlock / 16; i += kThreads) {
    const uint4 u = __ldg(row + i);
    reinterpret_cast<uint4*>(T)[i] = make_uint4(be32(u.x), be32(u.y), be32(u.z), be32(u.w));
  }
  if (t < kTailBytes / 4) T[kBlock / 4 + t] = 0u;
  const int32_t lo = range_lo(N, t), hi = lo + share;
  for (int32_t k = lo; k < hi; ++k) pad[order_index(k, shift)] = static_cast<uint16_t>(k);
  __syncthreads();

  uint16_t* srow = scratch + static_cast<size_t>(b) * N;
  const Order order{pad, shift};
  const ScratchStore st{srow, shift};
  for (int32_t R = 1; R < N; R <<= 1) {
    merge_range(T, P, n, order, R, lo, hi, st);
    __syncthreads();
    for (int32_t j = 0; j < share; ++j) pad[order_index(lo + j, shift)] = __ldcg(srow + j * kThreads + t);
    __syncthreads();
  }

  int32_t* len_row = out_len + static_cast<size_t>(b) * kBlock;
  int32_t* dist_row = out_dist + static_cast<size_t>(b) * kBlock;
  for (int32_t i = t; i < N; i += kThreads) {
    int32_t s;
    const Match m = slot_match(T, P, n, order, N, i, &s);
    len_row[s] = m.len;
    dist_row[s] = m.dist;
    for (int32_t j = 1; j < P.stride; ++j) {  // off-stride positions: no tier-B match
      len_row[s + j] = 0;
      dist_row[s + j] = 0;
    }
  }
}

// Dynamic shared memory a launch takes: the staged block, and the order at
// order_index over its padded range.
size_t smem_bytes(int stride) {
  return kTextWords * sizeof(uint32_t) + static_cast<size_t>(kBlock / stride + 2 * kThreads) * sizeof(uint16_t);
}

constexpr int kMaxDevices = 64;

// Lets tier_b_kernel take the dense launch's shared memory, once a device.
cudaError_t allow_smem() {
  static std::atomic<bool> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(tier_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(1)));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// key_ids packs the sort-key words four bits each, word t in bits 4t .. 4t + 3.
// The arguments are kernels/tier_b.py's, checked there: B >= 1, stride 1 or
// 4, 1-16 key words, ranks in rank_mask's low four bits.
extern "C" int snappy_tier_b_matches(const void* blocks, const void* lens, void* scratch, void* out_len,
                                     void* out_dist, int B, int stride, int nkeys, unsigned long long key_ids,
                                     int rank_mask, void* stream) {
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  Params P{stride, nkeys, rank_mask, {}};
  for (int t = 0; t < kKeyWords; ++t) P.key_ids[t] = static_cast<uint8_t>((key_ids >> (4 * t)) & 0xF);
  tier_b_kernel<<<B, kThreads, smem_bytes(stride), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(lens), static_cast<uint16_t*>(scratch),
      static_cast<int32_t*>(out_len), static_cast<int32_t*>(out_dist), P);
  return static_cast<int>(cudaGetLastError());
}
