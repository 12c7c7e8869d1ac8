// Row-wise top-k selection with the lowest index winning ties.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_select.py::
// topk_select (body _topk_kernel), and lax.top_k where the reference's
// ops.topk_select sends k > 64.
//
// Contract (bitwise, pinned by the plain versions in topk_select.py):
// values in descending order, equal values (-inf included) by ascending
// index, so a row of all -inf yields 0..k-1. Two orders differ at signed
// zeros (`signed_zeros`):
//   0: the Pallas body's. -0.0 and +0.0 tie (the key reads -0.0 as +0.0)
//      and each round writes the maximum of the entries still alive, so a
//      zero is written as +0.0 while a +0.0 is left at its index or after
//      it in the row (they all tie), else as -0.0: the block knows the
//      last index that holds +0.0 and compares.
//   1: lax.top_k's. +0.0 ranks above -0.0; each entry keeps its value.
//
// What bounds it on the H100: neither bytes nor operations. At the
// graph's shapes (N <= 144, k <= 80) a row is under 1 KB and the time is
// the latency of one pass over it; on the index's long rows (N = 32,768)
// it is the selection's passes over shared memory.
//
// Design:
//   * rows of at most 256 entries: one warp per row, eight rows a block,
//     no block barrier. The row sits in registers as packed 64-bit keys
//     (csrc/select.cuh), ceil(N/32) rounded up to a power of two per lane,
//     and a warp bitonic sort of the keys orders it: log2(32E)(log2(32E)+1)
//     /2 compare-exchange steps, each an independent shuffle per register,
//     whatever k is. That is chosen over k rounds of a warp argmax, whose
//     5 dependent shuffles a round make it cost grow with k (64-80 rounds
//     at the graph's merges).
//   * longer rows: split into chunks (select.cuh); a block selects each
//     chunk's top-min(k, chunk) in shared memory, and merge levels reduce
//     the survivors to the row's top k: levels of chunks while 2k <= the
//     chunk, else pairwise merges of the chunks' sorted runs in device
//     memory (any k <= N). Nothing lives in global memory but the
//     survivors between launches (a scratch the wrapper allocates).
//   * no device attribute is read per call: more than 48 KB of dynamic
//     shared memory is granted once per kernel and device.
#include "select.cuh"

#include <algorithm>
#include <cmath>

namespace {

using sel::kFull;
using sel::kThreads;

constexpr int kShortRow = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float written(uint64_t key, int last_pos_zero,
                                         bool tie) {
  float v = sel::key_value(key);
  if (tie && v == 0.0f && last_pos_zero < sel::key_index(key)) v = -0.0f;
  return v;
}

// Sorts the warp's 32*E keys (element j*32 + lane in v[j]) descending.
template <int E, int LOG>
__device__ __forceinline__ void warp_bitonic_desc(uint64_t (&v)[E],
                                                  int lane) {
#pragma unroll
  for (int ls = 1; ls <= LOG; ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
      if (stride >= 32) {
        const int js = stride >> 5;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          if ((j & js) == 0) {
            const bool desc = ((j * 32 + lane) & size) == 0;
            const uint64_t x = v[j], y = v[j + js];
            if (desc ? x < y : x > y) { v[j] = y; v[j + js] = x; }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const uint64_t o = __shfl_xor_sync(kFull, v[j], stride);
          const bool keep_max = ((lane & stride) == 0)
                                == (((j * 32 + lane) & size) == 0);
          v[j] = keep_max ? (v[j] > o ? v[j] : o) : (v[j] < o ? v[j] : o);
        }
      }
    }
  }
}

template <int E, int LOG>
__global__ void __launch_bounds__(kThreads)
short_rows_kernel(const float* __restrict__ scores, float* __restrict__ vals,
                  int* __restrict__ idxs, int B, int N, int k, bool tie) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;                        // the whole warp
  const float* s = scores + static_cast<size_t>(row) * N;
  uint64_t v[E];
  int last = -1;                               // last index holding +0.0
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = j * 32 + lane;
    v[j] = 0;                                  // padding sorts last
    if (e < N) {
      const float x = s[e];
      v[j] = sel::make_key(x, e, tie);
      if (__float_as_uint(x) == 0u) last = e;
    }
  }
  warp_bitonic_desc<E, LOG>(v, lane);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    last = max(last, __shfl_xor_sync(kFull, last, off));
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int p = j * 32 + lane;
    if (p < k) {
      vals[static_cast<size_t>(row) * k + p] = written(v[j], last, tie);
      idxs[static_cast<size_t>(row) * k + p] = sel::key_index(v[j]);
    }
  }
}

// The last step of a long row: the sorted survivors become (value, index),
// a block's worth at once (the halving merge) or one key at a time (the
// pairwise merge).
struct TopkFinal {
  float* vals;
  int* idxs;
  const int* last_zero;    // [B, chunks0]: per chunk, last +0.0 index or -1
  int chunks0;
  int k;
  bool tie;

  // The row's last +0.0 index (-1 if none; unused unless zeros tie), from
  // the first level's per-chunk answers. Whole block.
  __device__ int prepare(int row, unsigned* cell) const {
    if (!tie) return -1;
    if (threadIdx.x == 0) *cell = 0;
    __syncthreads();
    for (int c = threadIdx.x; c < chunks0; c += blockDim.x)
      atomicMax(cell, static_cast<unsigned>(
          last_zero[static_cast<size_t>(row) * chunks0 + c] + 1));
    __syncthreads();
    return static_cast<int>(*cell) - 1;
  }

  __device__ void emit(int row, int r, uint64_t key, int last) const {
    vals[static_cast<size_t>(row) * k + r] = written(key, last, tie);
    idxs[static_cast<size_t>(row) * k + r] = sel::key_index(key);
  }

  __device__ void write(int row, const sel::Smem& s, int last) const {
    for (int r = threadIdx.x; r < k; r += blockDim.x)
      emit(row, r, s.surv[r], last);
  }

  __device__ void operator()(int row, const sel::Smem& s) const {
    write(row, s, prepare(row, &s.scal[4]));
  }
};

// First level of a long row: block (chunk, row) keys its chunk of the
// scores and selects it (select.cuh).
__global__ void __launch_bounds__(kThreads)
scores_level_kernel(const float* __restrict__ scores, int N, int chunks,
                    uint64_t* __restrict__ out, int n_out,
                    int* __restrict__ last_zero, int k, int S,
                    TopkFinal fin) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = blockIdx.x % chunks;
  const int row = blockIdx.x / chunks;
  const int lo = chunk * S;
  const int n = min(S, N - lo);
  const int cap_n = min(S, N);
  const sel::Smem s = sel::carve(smem, cap_n,
                                 sel::pow2_ceil(min(k, cap_n)));
  if (threadIdx.x == 0) s.scal[4] = 0;
  __syncthreads();
  const float* src = scores + static_cast<size_t>(row) * N + lo;
  int last = -1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float x = src[i];
    s.keys[i] = sel::make_key(x, lo + i, fin.tie);
    if (__float_as_uint(x) == 0u) last = lo + i;
  }
  for (int off = 16; off > 0; off >>= 1)
    last = max(last, __shfl_xor_sync(kFull, last, off));
  if ((threadIdx.x & 31) == 0 && last >= 0)
    atomicMax(&s.scal[4], static_cast<unsigned>(last + 1));
  __syncthreads();
  sel::select_top(s, n, min(k, n));
  const int last_here = static_cast<int>(s.scal[4]) - 1;
  if (chunks == 1) {
    fin.write(row, s, last_here);
    return;
  }
  uint64_t* dst = out + static_cast<size_t>(row) * n_out
                  + static_cast<size_t>(chunk) * min(k, S);
  for (int i = threadIdx.x; i < min(k, n); i += blockDim.x) dst[i] = s.surv[i];
  if (threadIdx.x == 0)
    last_zero[static_cast<size_t>(row) * chunks + chunk] = last_here;
}

template <int E, int LOG>
cudaError_t launch_short(const float* scores, float* vals, int* idxs, int B,
                         int N, int k, bool tie, cudaStream_t stream) {
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  short_rows_kernel<E, LOG><<<blocks, kThreads, 0, stream>>>(
      scores, vals, idxs, B, N, k, tie);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// scores f32 [B, N] -> vals f32 [B, k], idxs i32 [B, k]. A row longer
// than 256 is split into chunks of S (the wrapper's chunk_plan), which
// needs a scratch of B * (2 * chunks * min(k, S) + chunks) int64 words
// when there is more than one chunk. One call is one launch for short
// rows or single-chunk rows, else two or more (1 + ceil(log2(chunks))
// when 2k > S).
extern "C" int topk_select_launch(const void* scores, void* vals, void* idxs,
                                  void* scratch, long long scratch_words,
                                  int B, int N, int k, int S,
                                  int signed_zeros, int device,
                                  void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > N || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scores);
  float* v = static_cast<float*>(vals);
  int* ix = static_cast<int*>(idxs);
  const bool tie = signed_zeros == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sel::on_device(device, [&]() -> cudaError_t {
    if (N <= kShortRow) {
      switch (sel::pow2_ceil((N + 31) / 32)) {
        case 1: return launch_short<1, 5>(sc, v, ix, B, N, k, tie, st);
        case 2: return launch_short<2, 6>(sc, v, ix, B, N, k, tie, st);
        case 4: return launch_short<4, 7>(sc, v, ix, B, N, k, tie, st);
        default: return launch_short<8, 8>(sc, v, ix, B, N, k, tie, st);
      }
    }
    const int chunks = (N + S - 1) / S;
    const int m0 = std::min(k, S);
    const size_t level = static_cast<size_t>(B) * chunks * m0;
    if (chunks > 1 && static_cast<size_t>(scratch_words)
                          < 2 * level + static_cast<size_t>(B) * chunks)
      return cudaErrorInvalidValue;
    uint64_t* keys = static_cast<uint64_t*>(scratch);
    uint64_t* other = chunks > 1 ? keys + level : nullptr;
    int* last_zero = chunks > 1 ? reinterpret_cast<int*>(other + level)
                                : nullptr;
    const TopkFinal fin{v, ix, last_zero, chunks, k, tie};
    const int n_out = sel::level_out(N, k, S);
    const int cap_n = std::min(N, S);
    const size_t bytes = sel::smem_bytes(cap_n,
                                         sel::pow2_ceil(std::min(k, cap_n)));
    static int granted[sel::kMaxDevices];
    cudaError_t err = sel::allow_smem(scores_level_kernel, bytes, device,
                                      granted);
    if (err != cudaSuccess) return err;
    scores_level_kernel<<<chunks * B, kThreads, bytes, st>>>(
        sc, N, chunks, keys, n_out, last_zero, k, S, fin);
    err = cudaGetLastError();
    if (err != cudaSuccess || chunks == 1) return err;
    if (2 * k <= S)
      return sel::merge_levels(keys, other, B, n_out, k, S, fin, device, st);
    return sel::merge_runs(keys, other, B, N, k, S, fin, st);
  });
}
