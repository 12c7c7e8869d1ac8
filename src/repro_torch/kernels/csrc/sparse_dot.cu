// Exact sparse-sparse dot products over fixed-nnz padded rows.
//
// Replaces two Pallas TPU kernels:
//   src/repro/kernels/sparse_dot.py::sparse_dot_batched (per-query rows,
//     db [B, R, Kd]: the shortlist rescore), and
//   src/repro/kernels/sparse_dot.py::sparse_dot (one db shared by every
//     query, db [N, Kd]: the exact brute-force index).
// Both have the body _sparse_dot_kernel: out[b, r] = sum over index pairs
// (i, j) with q_idx[b, i] == db_idx[r, j] != PAD_INDEX of q_val * db_val.
// sparse_dot_kernel serves both (the shared form is a db batch stride of
// 0). rescore_topk_kernel is sparse_dot_batched redesigned with what
// surrounds it on the index's path (src/repro/ann/scann.py:126-144): the
// shortlist's slot gather, the slab-row gather, the rescore, the mask and
// the final top-k in one launch.
//
// Indices are uint32 values stored in int64 tensors. The kernels read the
// low 32-bit word of each (the tensor viewed as int32, stride 2): the high
// word is always 0, so equality of low words is equality of the indices,
// and PAD_INDEX becomes -1.
//
// Sum order (both kernels, row_dot): db entry j outer, query entry i
// inner, products and sums rounded separately (no fused multiply-add), an
// add only on a match. The sum starts at +0.0 and in round-to-nearest
// never becomes -0.0, so skipping a non-match is adding +0.0: the plain
// version ref.sparse_dot_seq_ref adds where(match, q * d, 0) in the same
// order and agrees bit for bit.
//
// What bounds them on the H100: bytes. Each db row (Kd 8-byte indices and
// Kd float values) is read once per query and takes Kq x Kd integer
// compares; at Kq = Kd = 9 that is 81 compares per 108 bytes, far below
// the compute rate. In the shared form the db is read once per query row
// of the grid; a 262,144-row db of K = 9 is 28 MB, inside the 50 MB L2, so
// the repeats mostly hit L2. The rescore's bytes are a few hundred KB a
// call (R rows of 108 bytes per query), below a launch's worth of work, so
// its time is the latency of its dependent reads (slot, then row) and the
// sort, and fusing the gathers, mask and top-k that surrounded the old
// kernel on the path is what removes time.
//
// Design of sparse_dot_kernel: grid (ceil(R / 256), B), one thread per
// (query, db row); the block's query row (indices and values) is staged in
// shared memory and each thread walks its db row once.
//
// Design of rescore_topk_kernel: one block of 128 threads per query row.
// The query's indices and values and the R shortlist slots (slot =
// flat_slots[b, pos], or -1 where the shortlist score is not finite) are
// staged in shared memory. Then, a tile of 128 entries at a time, the
// block copies the tile's slab rows from sp_idx/sp_val into shared memory
// with consecutive threads on consecutive entries of a row (a warp reads
// whole 72- and 36-byte rows), and each thread scores one entry into a
// packed 64-bit key (csrc/select.cuh: value image, then ~position, so
// ties go to the lowest shortlist position and +0.0 ranks above -0.0, as
// lax.top_k orders). A bitonic sort of the pow2_ceil(R) keys in shared
// memory orders them, and the first k' become (slot, -score). No [B, R,
// Kd] copy of the slab rows exists. R goes up to 8,192, the longest
// shortlist the top-k kernels give (a row of two chunks taken whole):
// 64 KB of keys and 32 KB of slots, above the 48 KB default, so the
// launch opts in to the larger shared memory when R needs it.
#include "select.cuh"

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRescoreThreads = 128;    // also the shortlist entries a tile
constexpr int kMaxReorder = 8192;      // sparse_dot.py MAX_REORDER

// isfinite without the host math headers' overloads: exponent not all ones.
__device__ __forceinline__ bool finite(float x) {
  return (__float_as_uint(x) & 0x7F800000u) != 0x7F800000u;
}

// One padded sparse row against the query row in shared memory: db entry
// j outer, query entry i inner, separately rounded, added on a match.
__device__ __forceinline__ float row_dot(const int* qi, const float* qv,
                                         int Kq, const int* di,
                                         const float* dv, int d_stride,
                                         int Kd) {
  float acc = 0.0f;
  for (int j = 0; j < Kd; ++j) {
    const int dj = di[j * d_stride];
    const float dval = dv[j];
    for (int i = 0; i < Kq; ++i) {
      const int q = qi[i];
      if (q == dj && q != -1) acc = __fadd_rn(acc, __fmul_rn(qv[i], dval));
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
sparse_dot_kernel(const int* __restrict__ q_idx, const float* __restrict__ q_val,
                  const int* __restrict__ db_idx,
                  const float* __restrict__ db_val, float* __restrict__ out,
                  int R, int Kq, int Kd, long long db_batch_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* qi_s = reinterpret_cast<int*>(smem);
  float* qv_s = reinterpret_cast<float*>(qi_s + Kq);
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < Kq; i += kThreads) {
    qi_s[i] = q_idx[2 * ((size_t)b * Kq + i)];  // low word of the int64
    qv_s[i] = q_val[(size_t)b * Kq + i];
  }
  __syncthreads();
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const size_t row = ((size_t)b * db_batch_rows + r) * Kd;
  out[(size_t)b * R + r] = row_dot(qi_s, qv_s, Kq, db_idx + 2 * row,
                                   db_val + row, 2, Kd);
}

size_t rescore_smem_bytes(int R, int Kq, int Kd) {
  return sizeof(uint64_t) * sel::pow2_ceil(R)                  // keys
         + sizeof(int) * (R + Kq + (size_t)kRescoreThreads * Kd)  // slots, qi, tile
         + sizeof(float) * (Kq + (size_t)kRescoreThreads * Kd);   // qv, tile
}

__global__ void __launch_bounds__(kRescoreThreads)
rescore_topk_kernel(const int* __restrict__ q_idx,
                    const float* __restrict__ q_val,
                    const int* __restrict__ flat_slots, int N,
                    const int* __restrict__ short_pos,
                    const float* __restrict__ short_scores, int R,
                    const int* __restrict__ sp_idx,
                    const float* __restrict__ sp_val, int Kq, int Kd,
                    int k_out, int* __restrict__ final_slots,
                    float* __restrict__ dists) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = sel::pow2_ceil(R);
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);
  int* slot_s = reinterpret_cast<int*>(keys + P);
  int* qi_s = slot_s + R;
  int* ti_s = qi_s + Kq;                            // tile: slab indices
  float* qv_s = reinterpret_cast<float*>(ti_s + kRescoreThreads * Kd);
  float* tv_s = qv_s + Kq;                          // tile: slab values
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < Kq; i += kRescoreThreads) {
    qi_s[i] = q_idx[2 * ((size_t)b * Kq + i)];  // low word of the int64
    qv_s[i] = q_val[(size_t)b * Kq + i];
  }
  const size_t sb = (size_t)b * R;
  for (int e = tid; e < R; e += kRescoreThreads) {
    // -inf = invalid or a duplicate SOAR copy: out of the rescore
    slot_s[e] = finite(short_scores[sb + e])
                    ? flat_slots[(size_t)b * N + short_pos[sb + e]] : -1;
  }
  for (int e = R + tid; e < P; e += kRescoreThreads) keys[e] = 0;  // pads
  __syncthreads();
  for (int t0 = 0; t0 < R; t0 += kRescoreThreads) {
    const int n = min(kRescoreThreads, R - t0);
    for (int f = tid; f < n * Kd; f += kRescoreThreads) {
      const int e = f / Kd;
      const int slot = slot_s[t0 + e];
      int di = -1;
      float dv = 0.0f;
      if (slot >= 0) {
        const size_t at = (size_t)slot * Kd + (f - e * Kd);
        di = sp_idx[2 * at];
        dv = sp_val[at];
      }
      ti_s[f] = di;
      tv_s[f] = dv;
    }
    __syncthreads();
    if (tid < n) {
      const int e = t0 + tid;
      const float acc = row_dot(qi_s, qv_s, Kq, ti_s + tid * Kd,
                                tv_s + tid * Kd, 1, Kd);
      keys[e] = sel::make_key(slot_s[e] >= 0 ? acc : -INFINITY, e,
                              /*tie_zeros=*/false);
    }
    __syncthreads();
  }
  sel::bitonic_desc(keys, P);
  for (int p = tid; p < k_out; p += kRescoreThreads) {
    const uint64_t key = keys[p];
    const float v = sel::key_value(key);
    final_slots[(size_t)b * k_out + p] =
        finite(v) ? slot_s[sel::key_index(key)] : -1;
    dists[(size_t)b * k_out + p] = -v;
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q_idx [B, Kq] and db_idx [.., Kd] are int64 tensors passed as raw
// pointers; db_batch_rows is R for per-query rows and 0 for a shared db.
extern "C" int sparse_dot_launch(const void* q_idx, const void* q_val,
                                 const void* db_idx, const void* db_val,
                                 void* out, int B, int R, int Kq, int Kd,
                                 long long db_batch_rows, int device,
                                 void* stream) {
  if (B == 0 || R == 0) return 0;
  return sel::on_device(device, [&]() -> cudaError_t {
    const dim3 grid((R + kThreads - 1) / kThreads, B);
    const size_t smem = (size_t)Kq * (sizeof(int) + sizeof(float));
    sparse_dot_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(q_idx), static_cast<const float*>(q_val),
        static_cast<const int*>(db_idx), static_cast<const float*>(db_val),
        static_cast<float*>(out), R, Kq, Kd, db_batch_rows);
    return cudaGetLastError();
  });
}

// q_idx i64 [B, Kq], q_val f32 [B, Kq], flat_slots i32 [B, N], short_pos
// i32 [B, R], short_scores f32 [B, R], sp_idx i64 [cap, Kd], sp_val f32
// [cap, Kd] -> final_slots i32 [B, k_out], dists f32 [B, k_out]; one
// launch, 1 <= k_out <= R <= 8192.
extern "C" int sparse_rescore_topk_launch(
    const void* q_idx, const void* q_val, const void* flat_slots,
    const void* short_pos, const void* short_scores, const void* sp_idx,
    const void* sp_val, void* final_slots, void* dists, int B, int N, int R,
    int Kq, int Kd, int k_out, int device, void* stream) {
  if (R < 1 || R > kMaxReorder || k_out < 1 || k_out > R)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  return sel::on_device(device, [&]() -> cudaError_t {
    const size_t bytes = rescore_smem_bytes(R, Kq, Kd);
    static int granted[sel::kMaxDevices];
    cudaError_t err = sel::allow_smem(rescore_topk_kernel, bytes, device,
                                      granted);
    if (err != cudaSuccess) return err;
    rescore_topk_kernel<<<B, kRescoreThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(q_idx), static_cast<const float*>(q_val),
        static_cast<const int*>(flat_slots), N,
        static_cast<const int*>(short_pos),
        static_cast<const float*>(short_scores), R,
        static_cast<const int*>(sp_idx), static_cast<const float*>(sp_val),
        Kq, Kd, k_out, static_cast<int*>(final_slots),
        static_cast<float*>(dists));
    return cudaGetLastError();
  });
}
