// Fused query shortlist: ordered PQ-LUT scoring, lowest-index top-k and
// SOAR dedup-after-cut, in one kernel.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/fused_query.py:
//   fused_query_kernel (body _fused_kernel, _score_rows_f32, _select_dedup)
//   and fused_query_kernel_int8 (body _fused_kernel_int8, _score_rows_int8),
// as the two instances of one template.
//
// Contract (bitwise, pinned by the plain version in fused_query.py):
//   score[i] = valid[i] ? (((0 + lut[0][c0]) + lut[1][c1]) + ... ) + bias[i]
//                       : -inf               (subspaces summed in order)
//   (int8: lut[m][c] = qlut[m][c] * scale[m], one rounded product per
//   table entry while the table is staged, so the scale multiply stays out
//   of the sum and nothing can be contracted into an FMA)
//   k rounds of (max, lowest index) over an alive mask, so equal scores
//   (-inf included) resolve to the lowest candidate index and a row of all
//   -inf yields 0..k-1; the value of round i becomes -inf when an earlier
//   round selected the same point id with both entries valid.
//
// What bounds it on the H100: bytes. Each candidate is read once (M code
// bytes, a 4-byte id, a 1-byte valid flag, a 4-byte bias) and scored with M
// adds, far below the card's compute rate. The selection is k rounds over
// the candidate scores, which this kernel keeps on chip.
//
// Design: one block per query row.
//   * the row's LUT (M x C floats, 8 KB at M=8, C=256) is staged in shared
//     memory, so the code gathers hit shared memory, not device memory;
//   * each thread scores a stride of candidates into a score array and sets
//     an alive bit per candidate;
//   * each round is a block-wide (max, lowest index) reduction: per thread
//     over its stride, then warp shuffles, then one warp over the warps'
//     winners; thread 0 records the winner, checks the point id against the
//     ids already selected (kept in shared memory) and clears the alive bit.
//   * the scores and alive bits live in shared memory while they fit the
//     block's opt-in limit (227 KB on the H100, above 48 KB by opt-in); for
//     larger candidate counts the wrapper passes a global scratch buffer and
//     they live there instead, so every N the index can reach runs here.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  // (v, i) beats (bv, bi): higher value, then lower index; INT_MAX = none
  return i != INT_MAX && (bi == INT_MAX || v > bv || (v == bv && i < bi));
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
fused_query_kernel(const void* __restrict__ lut,
                   const float* __restrict__ scale,
                   const uint8_t* __restrict__ codes,
                   const int* __restrict__ ids,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ bias,
                   float* __restrict__ vals, int* __restrict__ idxs,
                   float* __restrict__ scratch_scores,
                   unsigned* __restrict__ scratch_alive,
                   int N, int M, int C, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = (N + 31) / 32;

  float* lut_s = reinterpret_cast<float*>(smem);            // M*C
  int* sel_ids = reinterpret_cast<int*>(lut_s + M * C);     // k
  int* sel_ok = sel_ids + k;                                // k
  float* warp_v = reinterpret_cast<float*>(sel_ok + k);     // kWarps
  int* warp_i = reinterpret_cast<int*>(warp_v + kWarps);    // kWarps
  float* scores;
  unsigned* alive;
  if (scratch_scores != nullptr) {
    scores = scratch_scores + (size_t)row * N;
    alive = scratch_alive + (size_t)row * words;
  } else {
    scores = reinterpret_cast<float*>(warp_i + kWarps);     // N
    alive = reinterpret_cast<unsigned*>(scores + N);        // words
  }

  if (kInt8) {
    const int8_t* q_row = static_cast<const int8_t*>(lut) + (size_t)row * M * C;
    const float* scale_row = scale + (size_t)row * M;
    for (int i = tid; i < M * C; i += kThreads)
      lut_s[i] = __fmul_rn(static_cast<float>(q_row[i]), scale_row[i / C]);
  } else {
    const float* lut_row = static_cast<const float*>(lut) + (size_t)row * M * C;
    for (int i = tid; i < M * C; i += kThreads) lut_s[i] = lut_row[i];
  }
  for (int w = tid; w < words; w += kThreads) {
    const int left = N - 32 * w;
    alive[w] = left >= 32 ? 0xFFFFFFFFu : ((1u << left) - 1u);
  }
  __syncthreads();

  const size_t base = (size_t)row * N;
  for (int i = tid; i < N; i += kThreads) {
    const uint8_t* c = codes + (base + i) * M;
    float acc = 0.0f;
    for (int m = 0; m < M; ++m) acc += lut_s[m * C + c[m]];
    scores[i] = valid[base + i] ? acc + bias[base + i] : -INFINITY;
  }
  __syncthreads();

  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < N; i += kThreads) {
      if ((alive[i >> 5] >> (i & 31)) & 1u) {
        const float v = scores[i];
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
      const int id_b = ids[base + bi];
      const int ok_b = valid[base + bi] != 0;
      bool dup = false;
      if (ok_b)
        for (int j = 0; j < r; ++j)
          if (sel_ok[j] && sel_ids[j] == id_b) { dup = true; break; }
      vals[(size_t)row * k + r] = dup ? -INFINITY : bv;
      idxs[(size_t)row * k + r] = bi;
      sel_ids[r] = id_b;
      sel_ok[r] = ok_b;
      alive[bi >> 5] &= ~(1u << (bi & 31));
    }
    __syncthreads();
  }
}

size_t fixed_smem_bytes(int M, int C, int k) {
  return sizeof(float) * (size_t)M * C + 2 * sizeof(int) * (size_t)k
         + kWarps * (sizeof(float) + sizeof(int));
}

size_t onchip_smem_bytes(int N, int M, int C, int k) {
  return fixed_smem_bytes(M, C, k) + sizeof(float) * (size_t)N
         + sizeof(unsigned) * (size_t)((N + 31) / 32);
}

int optin_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

template <bool kInt8>
int launch(const void* lut, const void* scale, const void* codes,
           const void* ids, const void* valid, const void* bias, void* vals,
           void* idxs, void* scratch_scores, void* scratch_alive, int B, int N,
           int M, int C, int k, void* stream) {
  const size_t smem = scratch_scores != nullptr
                          ? fixed_smem_bytes(M, C, k)
                          : onchip_smem_bytes(N, M, C, k);
  if (smem > (size_t)optin_limit()) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_query_kernel<kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_query_kernel<kInt8>
      <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          lut, static_cast<const float*>(scale),
          static_cast<const uint8_t*>(codes), static_cast<const int*>(ids),
          static_cast<const uint8_t*>(valid), static_cast<const float*>(bias),
          static_cast<float*>(vals), static_cast<int*>(idxs),
          static_cast<float*>(scratch_scores),
          static_cast<unsigned*>(scratch_alive), N, M, C, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 1 when the scores and alive bits of N candidates do not fit the block's
// shared memory and the wrapper must pass global scratch buffers.
extern "C" int fused_query_needs_scratch(int N, int M, int C, int k) {
  return onchip_smem_bytes(N, M, C, k) > (size_t)optin_limit() ? 1 : 0;
}

extern "C" int fused_query_launch(const void* lut, const void* codes,
                                  const void* ids, const void* valid,
                                  const void* bias, void* vals, void* idxs,
                                  void* scratch_scores, void* scratch_alive,
                                  int B, int N, int M, int C, int k,
                                  void* stream) {
  return launch<false>(lut, nullptr, codes, ids, valid, bias, vals, idxs,
                       scratch_scores, scratch_alive, B, N, M, C, k, stream);
}

// qlut i8 [B, M, C] and scale f32 [B, M] in place of the f32 table.
extern "C" int fused_query_int8_launch(const void* qlut, const void* scale,
                                       const void* codes, const void* ids,
                                       const void* valid, const void* bias,
                                       void* vals, void* idxs,
                                       void* scratch_scores,
                                       void* scratch_alive, int B, int N,
                                       int M, int C, int k, void* stream) {
  return launch<true>(qlut, scale, codes, ids, valid, bias, vals, idxs,
                      scratch_scores, scratch_alive, B, N, M, C, k, stream);
}
