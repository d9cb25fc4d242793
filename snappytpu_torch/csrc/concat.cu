// K1: variable-length row concatenation, the encoder's last step.
//
// Replaces the TPU kernel snappytpu/kernels/concat.py `_concat_kernel`
// (entry `concat_rows_words`, called by encode_v2._emit).  Per row b it
// writes the first lens[b, s] bytes of each of the S pieces back to back and
// zero-fills the rest of the row up to out_cap.
//
// What bounds it on the H100: bytes moved.  A main-path batch reads
// 128 x 64 x 1536 B of pieces and writes 128 x 73728 B of rows (~22 MB in
// all) with no arithmetic to speak of.  The TPU version needed funnel shifts
// over packed int32 words and 504-byte masked merges because the TPU has no
// byte loads or scalar stores; here the words are just their bytes.
//
// Design: one thread block per row.  Warp 0 takes an exclusive scan of the
// (clamped) section lengths in shared memory; then all threads copy each
// section to its offset with consecutive threads on consecutive bytes, and
// zero the tail.  Every write is clamped below out_cap, so a length sum past
// out_cap (outside the contract) never writes outside the row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
concat_rows_kernel(const uint8_t* __restrict__ pieces, const int32_t* __restrict__ lens,
                   uint8_t* __restrict__ out, int S, int cap, int out_cap) {
  extern __shared__ int32_t smem[];
  int32_t* len_s = smem;       // S clamped lengths
  int32_t* off_s = smem + S;   // S exclusive offsets, then the row total

  const int b = blockIdx.x;
  const uint8_t* src = pieces + static_cast<size_t>(b) * S * cap;
  uint8_t* dst = out + static_cast<size_t>(b) * out_cap;

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < S; base += 32) {
      const int s = base + lane;
      int v = s < S ? min(max(lens[static_cast<size_t>(b) * S + s], 0), cap) : 0;
      int incl = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      if (s < S) {
        len_s[s] = v;
        off_s[s] = carry + incl - v;
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) off_s[S] = carry;
  }
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const int off = off_s[s];
    const int n = min(len_s[s], out_cap - off);
    const uint8_t* piece = src + static_cast<size_t>(s) * cap;
    for (int k = threadIdx.x; k < n; k += blockDim.x) dst[off + k] = piece[k];
  }
  for (int k = min(off_s[S], out_cap) + threadIdx.x; k < out_cap; k += blockDim.x) dst[k] = 0;
}

}  // namespace

extern "C" int snappy_concat_rows(const void* pieces, const void* lens, void* out, int B, int S,
                                  int cap, int out_cap, void* stream) {
  const size_t smem = (2 * static_cast<size_t>(S) + 1) * sizeof(int32_t);
  concat_rows_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pieces), static_cast<const int32_t*>(lens),
      static_cast<uint8_t*>(out), S, cap, out_cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* snappy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
