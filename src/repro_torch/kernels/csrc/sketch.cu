// CountSketch of the index (ann/sparse.py::count_sketch) in one launch.
//
// Replaces no Pallas TPU kernel: the JAX package leaves count_sketch to
// XLA's scatter-add (src/repro/ann/sparse.py). The plain PyTorch version
// emulates the two uint32 uhash chains in int64, about 66 small
// elementwise kernels, then adds the K sparse columns one at a time (a
// gather, an add and an index_put each): some 110-140 launches a call,
// whose host cost, not the card, set the pace of every neighborhood RPC.
// One launch does all of it.
//
// Per column k of row b, with x = (uint32)indices[b, k]:
//   h = uhash(seed, x) % d_proj           the output coordinate
//   s = uhash(seed + 1, x) & 1 ? +1 : -1  the sign
//   t = indices[b, k] == PAD_INDEX ? 0 : values[b, k] * s
// and out[b, h] sums its terms in column order from +0.0, as the plain
// version's column loop does (the PAD test reads the int64 as it does).
// fmix32(seed) and fmix32(seed + 1) come from the host.
//
// One warp a row, no atomics: lane l hashes columns l, l + 32, ..., then
// for k = 0..K-1 in order a shuffle hands (h_k, t_k) to every lane and the
// lane that owns coordinate h_k (h_k mod 32) adds t_k with __fadd_rn. A
// lane owns coordinates l, l + 32, ... of the warp's accumulator row in
// shared memory: it zeroes them, adds to them and stores them, so no other
// lane ever touches them and no barrier is needed; the store of the row is
// coalesced. Rows come from a 64-bit grid-stride loop, so one launch
// serves 16 rows and a bootstrap's 1.47M.
//
// What bounds it on the H100: the bytes once, 12 B read a column (an int64
// index and a float value) and 4 * d_proj B written a row. At B =
// 1,469,417, K = 14 and d_proj = 64 that is about 623 MB, 0.19 ms at 3.35
// TB/s; the work is two hashes and a K-step shuffle loop a row. At an
// RPC's B = 16 the bound is nanoseconds and the launch's host cost is the
// time.
#include "hash.cuh"     // hashing::uhash
#include "select.cuh"   // sel::on_device, sel::kMaxDevices

#include <cstdint>

namespace {

constexpr int kWarps = 8;                  // rows in flight a block
constexpr int kThreads = 32 * kWarps;
constexpr long long kMaxBlocks = 8192;
constexpr int kMaxDProj = 1024;            // 32 KB of accumulators a block
constexpr long long kPadIndex = 0xFFFFFFFFll;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
count_sketch_kernel(const long long* __restrict__ indices, long long idx_row,
                    long long idx_col, const float* __restrict__ values,
                    long long val_row, long long val_col, long long B, int K,
                    int d_proj, uint32_t mix_h, uint32_t mix_s,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  float* acc = smem + (threadIdx.x >> 5) * d_proj;
  for (long long b = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5);
       b < B; b += (long long)gridDim.x * kWarps) {
    for (int c = lane; c < d_proj; c += 32) acc[c] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += 32) {
      int h = 0;
      float t = 0.0f;
      if (k0 + lane < K) {
        const long long raw = indices[b * idx_row + (k0 + lane) * idx_col];
        const uint32_t x = static_cast<uint32_t>(raw);
        h = static_cast<int>(hashing::uhash(x, mix_h)
                             % static_cast<uint32_t>(d_proj));
        const float sign = (hashing::uhash(x, mix_s) & 1u) ? 1.0f : -1.0f;
        const float v = values[b * val_row + (k0 + lane) * val_col];
        t = raw == kPadIndex ? 0.0f : __fmul_rn(v, sign);
      }
      const int n = K - k0 < 32 ? K - k0 : 32;
      for (int j = 0; j < n; ++j) {
        const int hj = __shfl_sync(kFull, h, j);
        const float tj = __shfl_sync(kFull, t, j);
        if ((hj & 31) == lane) acc[hj] = __fadd_rn(acc[hj], tj);
      }
    }
    for (int c = lane; c < d_proj; c += 32) out[b * d_proj + c] = acc[c];
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int sketch_max_d_proj() { return kMaxDProj; }

// indices i64 [B, K] (strides idx_row, idx_col), values f32 [B, K]
// (strides val_row, val_col) -> out f32 [B, d_proj], contiguous; every
// coordinate is written. mix_h = fmix32(seed), mix_s = fmix32(seed + 1).
extern "C" int count_sketch_launch(
    const void* indices, long long idx_row, long long idx_col,
    const void* values, long long val_row, long long val_col, long long B,
    int K, int d_proj, unsigned int mix_h, unsigned int mix_s, void* out,
    int device, void* stream) {
  if (B < 0 || K < 0 || d_proj < 1 || d_proj > kMaxDProj || device < 0
      || device >= sel::kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const long long want = (B + kWarps - 1) / kWarps;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  const size_t smem = sizeof(float) * kWarps * d_proj;
  return sel::on_device(device, [&]() -> cudaError_t {
    count_sketch_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(indices), idx_row, idx_col,
        static_cast<const float*>(values), val_row, val_col, B, K, d_proj,
        mix_h, mix_s, static_cast<float*>(out));
    return cudaGetLastError();
  });
}
