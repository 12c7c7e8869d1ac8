// Fused query shortlist: ordered PQ-LUT scoring, lowest-index top-k and
// SOAR dedup-after-cut.
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
//   the top k by (score descending, lowest candidate index), so equal
//   scores (-inf included) resolve to the lowest index and a row of all
//   -inf yields 0..k-1; the value of entry r becomes -inf when an entry
//   j < r holds the same point id with both entries valid.
//
// Signed zeros: the key (csrc/select.cuh) ranks +0.0 above -0.0, as the
// plain version's lax.top_k order does, but no score is ever -0.0. The sum
// starts at +0.0, and in round-to-nearest x + y is -0.0 only when both are
// -0.0 (an exact cancellation gives +0.0), so acc is never -0.0 and
// neither is acc + bias; an invalid entry is -inf. So this order and the
// Pallas body's (which ties the two zeros) give the same answer here.
//
// What bounds it on the H100: bytes. Each candidate is read once (M code
// bytes, a 4-byte id, a 1-byte valid flag, a 4-byte bias) and scored with M
// adds, far below the card's compute rate.
//
// Design: the candidates of a row are split over blocks, so B=16 queries
// fill the card. One call is two kernel launches (more only when a row
// has over 32 chunks' survivors, or when 2k > S):
//   * pass 1, one block per (chunk of S candidates, query row); S = 4,096
//     is one probed slab, so the main path's B=16 x 8 slabs give 128
//     blocks. The row's table is staged in shared memory (8 KB at M=8,
//     C=256), each thread scores candidates (the 8 code bytes in one
//     8-byte load) into packed keys in shared memory, and the block
//     selects the chunk's top-min(k, S) (select.cuh: radix select,
//     compaction, bitonic sort) into a [B, chunks, k] scratch. 42 KB of
//     shared memory a block, so five blocks fit an SM;
//   * pass 2, one block per row: merges the chunks' survivors to the
//     row's top k, gathers the k selected ids and valid flags into shared
//     memory, and entry r checks the entries j < r for its id: k^2/2
//     comparisons spread over the block in place of one thread's scan.
//   A row of one chunk takes pass 1 only. The dedup waits for the final
//   order, so no chunk checks duplicates.
//   When 2k > S on a row of more than one chunk (k > 4,096, or k > 2,048
//   past 8,192 candidates), one merge block cannot hold the survivors:
//   the chunks' sorted runs are merged pairwise in device memory
//   (select.cuh merge_runs), the last merge writes the row's values and
//   indices, and dedup_kernel then checks entry r against the entries
//   j < r, a tile of 256 entries a block with the earlier ids staged in
//   shared memory 256 at a time.
#include "select.cuh"

#include <algorithm>
#include <cmath>

namespace {

using sel::kThreads;

// The last step: the sorted survivors become (value, index), with the
// dedup-after-cut. The selected ids and flags reuse the keys' space.
struct FusedFinal {
  const int* ids;
  const uint8_t* valid;
  float* vals;
  int* idxs;
  int N;
  int k;

  // One key at a time (the pairwise merge's last level); dedup_kernel
  // follows.
  __device__ int prepare(int, unsigned*) const { return 0; }

  __device__ void emit(int row, int r, uint64_t key, int) const {
    vals[static_cast<size_t>(row) * k + r] = sel::key_value(key);
    idxs[static_cast<size_t>(row) * k + r] = sel::key_index(key);
  }

  __device__ void operator()(int row, const sel::Smem& s) const {
    int* sel_id = reinterpret_cast<int*>(s.keys);
    int* sel_ok = sel_id + k;
    const size_t base = static_cast<size_t>(row) * N;
    for (int r = threadIdx.x; r < k; r += blockDim.x) {
      const int i = sel::key_index(s.surv[r]);
      sel_id[r] = ids[base + i];
      sel_ok[r] = valid[base + i] != 0;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < k; r += blockDim.x) {
      const uint64_t key = s.surv[r];
      bool dup = false;
      if (sel_ok[r]) {
        const int id = sel_id[r];
        for (int j = 0; j < r; ++j)
          if (sel_ok[j] && sel_id[j] == id) { dup = true; break; }
      }
      vals[static_cast<size_t>(row) * k + r] =
          dup ? -INFINITY : sel::key_value(key);
      idxs[static_cast<size_t>(row) * k + r] = sel::key_index(key);
    }
  }
};

// The dedup-after-cut of rows the pairwise merge wrote: block (tile, row)
// takes entries [tile * kThreads, +kThreads) and checks each against the
// row's earlier entries, whose ids and valid flags are staged in shared
// memory a tile at a time.
__global__ void __launch_bounds__(kThreads)
dedup_kernel(const int* __restrict__ ids, const uint8_t* __restrict__ valid,
             const int* __restrict__ idxs, float* __restrict__ vals, int N,
             int k, int tiles) {
  __shared__ int sid[kThreads];
  __shared__ bool sok[kThreads];
  const int tile = blockIdx.x % tiles;
  const int row = blockIdx.x / tiles;
  const int r = tile * kThreads + threadIdx.x;
  const size_t base = static_cast<size_t>(row) * N;
  const int* ir = idxs + static_cast<size_t>(row) * k;
  int id = 0;
  bool ok = false;
  if (r < k) {
    id = ids[base + ir[r]];
    ok = valid[base + ir[r]] != 0;
  }
  bool dup = false;
  const int end = min(k, (tile + 1) * kThreads);
  for (int j0 = 0; j0 < end; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    if (j < end) {
      sid[threadIdx.x] = ids[base + ir[j]];
      sok[threadIdx.x] = valid[base + ir[j]] != 0;
    }
    __syncthreads();
    if (ok && !dup) {
      const int n = min(kThreads, r - j0);       // the entries j < r
      for (int t = 0; t < n; ++t)
        if (sok[t] && sid[t] == id) { dup = true; break; }
    }
    __syncthreads();
  }
  if (dup) vals[static_cast<size_t>(row) * k + r] = -INFINITY;
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
fused_chunk_kernel(const void* __restrict__ lut,
                   const float* __restrict__ scale,
                   const uint8_t* __restrict__ codes,
                   const float* __restrict__ bias, int N, int M, int C,
                   int chunks, uint64_t* __restrict__ out, int n_out, int k,
                   int S, FusedFinal fin) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = blockIdx.x % chunks;
  const int row = blockIdx.x / chunks;
  const int tid = threadIdx.x;
  const int lo = chunk * S;
  const int n = min(S, N - lo);
  const int cap_n = min(S, N);
  const sel::Smem s = sel::carve(smem, cap_n,
                                 sel::pow2_ceil(min(k, cap_n)));
  float* lut_s = reinterpret_cast<float*>(s.extra);     // M*C

  if (kInt8) {
    const int8_t* q_row = static_cast<const int8_t*>(lut) + (size_t)row * M * C;
    const float* scale_row = scale + (size_t)row * M;
    for (int i = tid; i < M * C; i += kThreads)
      lut_s[i] = __fmul_rn(static_cast<float>(q_row[i]), scale_row[i / C]);
  } else {
    const float* lut_row = static_cast<const float*>(lut) + (size_t)row * M * C;
    for (int i = tid; i < M * C; i += kThreads) lut_s[i] = lut_row[i];
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(row) * N + lo;
  const bool packed = M == 8 && (reinterpret_cast<uintptr_t>(codes) & 7u) == 0;
  for (int i = tid; i < n; i += kThreads) {
    const uint8_t* c = codes + (base + i) * M;
    float acc = 0.0f;
    if (packed) {
      const uint2 w = *reinterpret_cast<const uint2*>(c);
#pragma unroll
      for (int m = 0; m < 4; ++m) acc += lut_s[m * C + ((w.x >> (8 * m)) & 0xFFu)];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        acc += lut_s[(m + 4) * C + ((w.y >> (8 * m)) & 0xFFu)];
    } else {
      for (int m = 0; m < M; ++m) acc += lut_s[m * C + c[m]];
    }
    const float score = fin.valid[base + i] ? acc + bias[base + i] : -INFINITY;
    s.keys[i] = sel::make_key(score, lo + i, false);
  }
  __syncthreads();
  sel::select_top(s, n, min(k, n));
  if (chunks == 1) {
    fin(row, s);
    return;
  }
  uint64_t* dst = out + static_cast<size_t>(row) * n_out
                  + static_cast<size_t>(chunk) * min(k, S);
  for (int i = tid; i < min(k, n); i += kThreads) dst[i] = s.surv[i];
}

template <bool kInt8>
int launch(const void* lut, const void* scale, const void* codes,
           const void* ids, const void* valid, const void* bias, void* vals,
           void* idxs, void* scratch, long long scratch_words, int B, int N,
           int M, int C, int k, int S, int device, void* stream) {
  if (B == 0) return 0;
  if (k < 1 || k > N || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sel::on_device(device, [&]() -> cudaError_t {
    const int chunks = (N + S - 1) / S;
    const size_t level = static_cast<size_t>(B) * chunks * std::min(k, S);
    if (chunks > 1 && static_cast<size_t>(scratch_words) < 2 * level)
      return cudaErrorInvalidValue;
    uint64_t* keys = static_cast<uint64_t*>(scratch);
    uint64_t* other = chunks > 1 ? keys + level : nullptr;
    const FusedFinal fin{static_cast<const int*>(ids),
                         static_cast<const uint8_t*>(valid),
                         static_cast<float*>(vals), static_cast<int*>(idxs),
                         N, k};
    const int n_out = sel::level_out(N, k, S);
    const int cap_n = std::min(N, S);
    const size_t bytes = sel::smem_bytes(cap_n,
                                         sel::pow2_ceil(std::min(k, cap_n)))
                         + sizeof(float) * static_cast<size_t>(M) * C;
    static int granted[sel::kMaxDevices];
    cudaError_t err = sel::allow_smem(fused_chunk_kernel<kInt8>, bytes,
                                      device, granted);
    if (err != cudaSuccess) return err;
    fused_chunk_kernel<kInt8><<<chunks * B, kThreads, bytes, st>>>(
        lut, static_cast<const float*>(scale),
        static_cast<const uint8_t*>(codes), static_cast<const float*>(bias),
        N, M, C, chunks, keys, n_out, k, S, fin);
    err = cudaGetLastError();
    if (err != cudaSuccess || chunks == 1) return err;
    if (2 * k <= S)
      return sel::merge_levels(keys, other, B, n_out, k, S, fin, device, st);
    err = sel::merge_runs(keys, other, B, N, k, S, fin, st);
    if (err != cudaSuccess) return err;
    const int tiles = (k + kThreads - 1) / kThreads;
    dedup_kernel<<<tiles * B, kThreads, 0, st>>>(
        static_cast<const int*>(ids), static_cast<const uint8_t*>(valid),
        static_cast<const int*>(idxs), static_cast<float*>(vals), N, k,
        tiles);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// lut f32 [B, M, C]; codes u8 [B, N, M]; ids i32 [B, N]; valid u8 [B, N];
// bias f32 [B, N] -> vals f32 [B, k], idxs i32 [B, k]. Chunks of S
// candidates (the wrapper's chunk_plan); with more than one chunk the
// scratch holds at least 2 * B * chunks * min(k, S) int64 words.
extern "C" int fused_query_launch(const void* lut, const void* codes,
                                  const void* ids, const void* valid,
                                  const void* bias, void* vals, void* idxs,
                                  void* scratch, long long scratch_words,
                                  int B, int N, int M, int C, int k, int S,
                                  int device, void* stream) {
  return launch<false>(lut, nullptr, codes, ids, valid, bias, vals, idxs,
                       scratch, scratch_words, B, N, M, C, k, S, device,
                       stream);
}

// qlut i8 [B, M, C] and scale f32 [B, M] in place of the f32 table.
extern "C" int fused_query_int8_launch(const void* qlut, const void* scale,
                                       const void* codes, const void* ids,
                                       const void* valid, const void* bias,
                                       void* vals, void* idxs, void* scratch,
                                       long long scratch_words, int B, int N,
                                       int M, int C, int k, int S, int device,
                                       void* stream) {
  return launch<true>(qlut, scale, codes, ids, valid, bias, vals, idxs,
                      scratch, scratch_words, B, N, M, C, k, S, device,
                      stream);
}
