// T1: the scalar-chain probes — the primitives a decoder's serial chain is
// made of, each timed as one dependent chain.
//
// Replaces the 16 TPU kernels of tools/probe_scalar.py (the `run` closures of
// smem_chase, vmem_scalar, dynrow_chain, alu_chain, alu_unroll, smem_unroll,
// while_unroll, dynrow_noextract, dynrow_write, smem_par, dynrow_par,
// dynrmw_par, bigstate_par, vec_chain, split_ref_chain and rmw_chain_same).
// The bodies, and how each TPU primitive maps onto Hopper, are in
// probe_scalar.cuh.
//
// What bounds each probe is the latency of one step of its chain: that is
// what it measures, and every cost of a step is the SM's own (registers,
// shared memory, L1).  So one launch runs a list of probe shapes, one thread
// block of one warp each: block i takes row i of a table (kind, a, b, input
// offset), and a switch over every shape of probe_scalar.cuh runs its body.
// The TPU ran one probe per launch on its one core; here the 61 shapes of
// the JAX tool's five sections run side by side, one SM each.  A block
// keeps its SM to itself by its dynamic shared memory: the launcher asks,
// for every block, for more than half of what an SM holds (the largest
// probe needs 202,752 bytes of scratch), so the scheduler places one block
// on an SM.  A probe that chases global memory through L1 (vmem_scalar) is
// launched apart with the least request that still keeps it alone, so that
// L1 keeps its table.  Each block writes the SM it ran on, and the host
// refuses a run in which two blocks shared one.
//
// Timing: clock64() and %globaltimer are read by every lane around the chain
// after a __syncwarp and again after the chain's result is stored and the
// warp synchronised; lane 0 writes {cycles, ns, SM, start ns}.  clock64
// counts the block's own SM's cycles, so cycles per step do not depend on
// which SM ran it; ns do, with that SM's clock.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_ring.cuh"
#include "probe_scalar.cuh"

namespace {

using snappy_probe::kTile;
constexpr int kClk = 4;  // {cycles, ns, SM, start ns} per block
constexpr int kMaxSmem = (kTile + 6 * snappy_probe::kScr) * static_cast<int>(sizeof(int32_t));

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned s;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(s));
  return s;
}

// One block's probe: the tile and the input's staged words, then the zeroed
// scratch, in the dynamic shared memory; a block given too little of it
// writes cycles -1 and runs nothing.
template <class P>
__device__ __forceinline__ void probe_block(const int32_t* __restrict__ in, int32_t* smem, int32_t* __restrict__ out,
                                            long long* __restrict__ clk, int n) {
  const int lane = static_cast<int>(threadIdx.x);
  if (dynamic_smem_bytes() < (kTile + P::kStage + P::kZero) * sizeof(int32_t)) {
    if (lane == 0) clk[0] = -1;
    return;
  }
  int32_t* tile = smem;
  int32_t* s = smem + kTile;
  for (int i = lane; i < P::kStage; i += 32) s[i] = in[i];
  for (int i = lane; i < P::kZero; i += 32) s[P::kStage + i] = 0;
  for (int i = lane; i < kTile; i += 32) tile[i] = 0;
  snappy_ring::DeviceWarp w{lane};
  __syncwarp();
  const long long c0 = clock64();
  const long long t0 = global_ns();
  P::run(w, in, s, n, tile);
  __syncwarp();
  const long long c1 = clock64();
  const long long t1 = global_ns();
  if (lane == 0) {
    clk[0] = c1 - c0;
    clk[1] = t1 - t0;
    clk[2] = sm_id();
    clk[3] = t0;
  }
  for (int i = lane; i < kTile; i += 32) out[i] = P::kScalar ? tile[0] : tile[i];
}

// Block i runs the probe of table row i = (kind, a, b, offset of its input
// in `in`) into tile i of out and clocks i of clk.
__global__ void __launch_bounds__(32)
probe_kernel(const int4* __restrict__ table, const int32_t* __restrict__ in, int32_t* __restrict__ out,
             long long* __restrict__ clk, int n) {
  extern __shared__ __align__(16) int32_t smem[];
  const int4 e = table[blockIdx.x];
  out += static_cast<size_t>(blockIdx.x) * kTile;
  clk += static_cast<size_t>(blockIdx.x) * kClk;
#define SNAPPY_RUN(k, A, B, ...) \
  if (e.x == k && e.y == A && e.z == B) return probe_block<__VA_ARGS__>(in + e.w, smem, out, clk, n);
  SNAPPY_PROBE_SHAPES(SNAPPY_RUN)
#undef SNAPPY_RUN
  if (threadIdx.x == 0) clk[0] = -2;  // a shape that is not built
}

}  // namespace

// table: `blocks` int4 rows (kind, a, b, input offset in words), kind the
// probe's index in tools/probe_scalar.py KINDS and a, b its parameters;
// smem: the dynamic shared memory of every block (its tile, staged input
// and scratch, or more); in: the inputs (tables or seeds); out: an (8, 128)
// int32 tile per block; clk: {cycles, ns, SM, start ns} per block (cycles
// -1: too little shared memory, -2: a shape not built); n: steps.
extern "C" int snappy_probe_scalar(const void* table, int blocks, int smem, const void* in, void* out, void* clk,
                                   int n, void* stream) {
  if (blocks <= 0 || smem < 0 || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)  // shared memory only as large as the launch asks: L1 keeps the rest
    err = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxL1);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), static_cast<const int32_t*>(in), static_cast<int32_t*>(out),
      static_cast<long long*>(clk), n);
  return static_cast<int>(cudaGetLastError());
}
