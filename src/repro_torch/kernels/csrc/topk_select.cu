// Row-wise top-k selection with the lowest index winning ties.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_select.py::
// topk_select (body _topk_kernel).
//
// Contract (bitwise, pinned by the plain version in topk_select.py, which
// is lax.top_k's order): k rounds of (max, lowest index) over an alive
// mask; round r writes the winner's value and index and clears its alive
// bit. Equal scores (-inf included) resolve to the lowest index, so a row
// of all -inf yields 0..k-1.
//
// What bounds it on the H100: neither bytes nor operations. The function
// reads N floats and writes k (value, index) pairs per row; at the graph's
// shapes (N <= 128, k <= 64) that is under 1 KB a row. The time is the k
// dependent rounds, each a block-wide reduction with two barriers.
//
// Design: one block per row, the selection loop of fused_query.cu. Each
// round every thread takes the best alive entry of its stride of the row
// (read from device memory, which L1 holds after the first round), then
// warp shuffles and one warp over the warps' winners pick the row's
// winner. The alive bits live in shared memory while they fit the block's
// opt-in limit (N up to about 1.8 million); beyond it the wrapper passes a
// global scratch buffer, so every N runs here. The block has 128 threads:
// the graph's rows are at most 128 long, so each thread holds at most one
// entry there.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  // (v, i) beats (bv, bi): higher value, then lower index; INT_MAX = none
  return i != INT_MAX && (bi == INT_MAX || v > bv || (v == bv && i < bi));
}

__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                   int* __restrict__ idxs, unsigned* __restrict__ scratch_alive,
                   int N, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = (N + 31) / 32;

  float* warp_v = reinterpret_cast<float*>(smem);             // kWarps
  int* warp_i = reinterpret_cast<int*>(warp_v + kWarps);      // kWarps
  unsigned* alive = scratch_alive != nullptr
                        ? scratch_alive + (size_t)row * words
                        : reinterpret_cast<unsigned*>(warp_i + kWarps);

  for (int w = tid; w < words; w += kThreads) {
    const int left = N - 32 * w;
    alive[w] = left >= 32 ? 0xFFFFFFFFu : ((1u << left) - 1u);
  }
  __syncthreads();

  const float* s = scores + (size_t)row * N;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < N; i += kThreads) {
      if ((alive[i >> 5] >> (i & 31)) & 1u) {
        const float v = s[i];
        if (bi == INT_MAX || v > bv) { bv = v; bi = i; }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xFFFFFFFFu, bv, off);
      const int oi = __shfl_down_sync(0xFFFFFFFFu, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { warp_v[warp] = bv; warp_i[warp] = bi; }
    __syncthreads();
    if (tid == 0) {
      bv = warp_v[0];
      bi = warp_i[0];
      for (int w = 1; w < kWarps; ++w)
        if (better(warp_v[w], warp_i[w], bv, bi)) { bv = warp_v[w]; bi = warp_i[w]; }
      vals[(size_t)row * k + r] = bv;
      idxs[(size_t)row * k + r] = bi;
      alive[bi >> 5] &= ~(1u << (bi & 31));
    }
    __syncthreads();
  }
}

size_t fixed_smem_bytes() { return kWarps * (sizeof(float) + sizeof(int)); }

size_t onchip_smem_bytes(int N) {
  return fixed_smem_bytes() + sizeof(unsigned) * (size_t)((N + 31) / 32);
}

int optin_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 1 when the alive bits of N entries do not fit the block's shared memory
// and the wrapper must pass a global scratch buffer of B x ceil(N/32) words.
extern "C" int topk_select_needs_scratch(int N) {
  return onchip_smem_bytes(N) > (size_t)optin_limit() ? 1 : 0;
}

extern "C" int topk_select_launch(const void* scores, void* vals, void* idxs,
                                  void* scratch_alive, int B, int N, int k,
                                  void* stream) {
  if (B == 0) return 0;
  const size_t smem = scratch_alive != nullptr ? fixed_smem_bytes()
                                               : onchip_smem_bytes(N);
  if (smem > (size_t)optin_limit()) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  topk_select_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<float*>(vals),
      static_cast<int*>(idxs), static_cast<unsigned*>(scratch_alive), N, k);
  return (int)cudaGetLastError();
}
