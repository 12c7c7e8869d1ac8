// Exact sparse-sparse dot products over fixed-nnz padded rows.
//
// Replaces two Pallas TPU kernels:
//   src/repro/kernels/sparse_dot.py::sparse_dot_batched (per-query rows,
//     db [B, R, Kd]: the shortlist rescore), and
//   src/repro/kernels/sparse_dot.py::sparse_dot (one db shared by every
//     query, db [N, Kd]: the exact brute-force index).
// Both have the body _sparse_dot_kernel: out[b, r] = sum over index pairs
// (i, j) with q_idx[b, i] == db_idx[r, j] != PAD_INDEX of q_val * db_val.
// sparse_dot_kernel is the per-query form; shared_dot_kernel the shared
// one. rescore_topk_kernel is sparse_dot_batched redesigned with what
// surrounds it on the index's path (src/repro/ann/scann.py:126-144): the
// shortlist's slot gather, the slab-row gather, the rescore, the mask and
// the final top-k in one launch.
//
// Indices are uint32 values stored in int64 tensors. The kernels read the
// low 32-bit word of each (the tensor viewed as int32, stride 2): the high
// word is always 0, so equality of low words is equality of the indices,
// and PAD_INDEX becomes -1.
//
// Sum order (every kernel): db entry j outer, query entry i inner,
// products and sums rounded separately (no fused multiply-add), an add
// only on a match. The sum starts at +0.0 and in round-to-nearest never
// becomes -0.0, so skipping a non-match is adding +0.0: the plain version
// ref.sparse_dot_seq_ref adds where(match, q * d, 0) in the same order and
// agrees bit for bit.
//
// What bounds the per-query forms: each db row (Kd 8-byte indices and Kd
// float values) is read once and takes Kq x Kd integer compares, 81 per
// 108 bytes at Kq = Kd = 9, far below the compute rate. The rescore's
// bytes are a few hundred KB a call (R rows of 108 bytes per query),
// below a launch's worth of work, so its time is the latency of its
// dependent reads (slot, then row) and the sort, and fusing the gathers,
// mask and top-k that surrounded the old kernel on the path is what
// removes time.
//
// Design of sparse_dot_kernel (per-query rows): grid (ceil(R / 256), B),
// one thread per (query, db row); the block's query row is staged in
// shared memory and each thread walks its db row once.
//
// Design of shared_dot_kernel (one db for every query; the brute index).
// A thread per (query, db row) would re-read the whole db once per query
// row (from L2: 64 queries x 14 MB at N = 131,072) with loads 72 bytes
// apart across a warp, and compare every (i, j) pair: 64 x 81 compares
// per db row. Instead:
// - one block of 128 threads per tile of 128 db rows; the tile is copied
//   into shared memory with consecutive threads on consecutive entries
//   (coalesced), at an odd row stride (conflict-free reads); the db is
//   read from device memory once, whatever B is;
// - the queries come in chunks of 32 rows. A chunk's entries go into an
//   open-addressing hash table in shared memory keyed by index, one slot
//   per distinct (query row, index), holding the lowest position i; a
//   query row's repeats of an index are chained in ascending i. Padding
//   is never inserted;
// - each thread walks its row's Kd entries in order and looks each index
//   up (about 1.3 probes at the table's load of at most 1/2): a compare
//   is paid only where an index exists in some query of the chunk, and
//   each match adds q * d to that query's sum, kept in shared memory
//   (one column per thread, conflict-free). For a fixed query the adds
//   come in j-outer, i-inner order, the order above;
// - the chunk's sums are written out[b, r] coalesced per query row, -inf
//   where the optional row mask `valid` is false (the brute index's
//   tombstones, so the search needs no masking pass over [B, N]).
// What bounds it: bytes, B x N x 4 written and N x Kd x 12 read (the
// int64 indices' high words are fetched with the low ones); the hash
// table's build is a few hundred shared-memory operations per block and
// chunk, the lookups Kd probes per row and chunk.
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
constexpr int kTileRows = 128;         // shared form: db rows (threads) a block
constexpr int kQueryChunk = 32;        // shared form: query rows a table holds

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
                  int R, int Kq, int Kd) {
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
  const size_t row = ((size_t)b * R + r) * Kd;
  out[(size_t)b * R + r] = row_dot(qi_s, qv_s, Kq, db_idx + 2 * row,
                                   db_val + row, 2, Kd);
}

// Home slot of an index in a table of 2^log_slots slots (Fibonacci hash).
__device__ __forceinline__ int home_slot(int key, int log_slots) {
  return static_cast<int>((static_cast<uint32_t>(key) * 2654435761u) >>
                          (32 - log_slots));
}

size_t shared_smem_bytes(int Kq, int Kd, int log_slots) {
  const size_t qk = (size_t)kQueryChunk * Kq;
  return sizeof(int2) * ((size_t)1 << log_slots)          // hash table
         + sizeof(float) * kQueryChunk * kTileRows          // sums
         + (sizeof(int) + sizeof(float)) * kTileRows * (Kd | 1)  // tile
         + (2 * sizeof(int) + sizeof(float)) * qk;          // qi, chain, qv
}

__global__ void __launch_bounds__(kTileRows)
shared_dot_kernel(const int* __restrict__ q_idx,
                  const float* __restrict__ q_val,
                  const int* __restrict__ db_idx,
                  const float* __restrict__ db_val,
                  const bool* __restrict__ valid, float* __restrict__ out,
                  int B, int N, int Kq, int Kd, int log_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_slots = 1 << log_slots;
  const int S = Kd | 1;                    // odd stride: no bank conflicts
  int2* table = reinterpret_cast<int2*>(smem);   // (index, position) or -1
  float* sums = reinterpret_cast<float*>(table + n_slots);
  int* ti = reinterpret_cast<int*>(sums + kQueryChunk * kTileRows);
  float* tv = reinterpret_cast<float*>(ti + kTileRows * S);
  int* qi = reinterpret_cast<int*>(tv + kTileRows * S);
  int* chain = qi + kQueryChunk * Kq;      // next position, same row+index
  float* qv = reinterpret_cast<float*>(chain + kQueryChunk * Kq);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, N - r0);
  const size_t base = (size_t)r0 * Kd;
  for (int f = tid; f < rows * Kd; f += kTileRows) {
    const int e = f / Kd;
    ti[e * S + f - e * Kd] = db_idx[2 * (base + f)];   // low word
    tv[e * S + f - e * Kd] = db_val[base + f];
  }
  const int r = r0 + tid;
  const bool live = tid < rows;
  const bool dead = live && valid != nullptr && !valid[r];
  float* mine = sums + tid;                // this thread's column
  for (int b0 = 0; b0 < B; b0 += kQueryChunk) {
    const int qb = min(kQueryChunk, B - b0);
    const int qk = qb * Kq;
    __syncthreads();                       // the last chunk's lookups ended
    for (int s = tid; s < n_slots; s += kTileRows) table[s] = make_int2(-1, 0);
    for (int e = tid; e < qk; e += kTileRows) {
      qi[e] = q_idx[2 * ((size_t)b0 * Kq + e)];
      qv[e] = q_val[(size_t)b0 * Kq + e];
    }
    __syncthreads();
    for (int e = tid; e < qk; e += kTileRows) {
      const int key = qi[e];
      const int row = e - e % Kq;
      int next = -1;
      bool first = true;
      for (int f = row; f < row + Kq; ++f) {
        if (qi[f] != key) continue;
        if (f < e) first = false;
        if (f > e && next < 0) next = f;
      }
      chain[e] = next;
      if (key == -1 || !first) continue;
      int s = home_slot(key, log_slots);
      while (atomicCAS(&table[s].x, -1, key) != -1) s = (s + 1) & (n_slots - 1);
      table[s].y = e;
    }
    __syncthreads();
    if (!live) continue;
    for (int q = 0; q < qb; ++q) mine[q * kTileRows] = 0.0f;
    for (int j = 0; j < Kd && !dead; ++j) {
      const int dj = ti[tid * S + j];
      if (dj == -1) continue;
      const float dval = tv[tid * S + j];
      for (int s = home_slot(dj, log_slots);; s = (s + 1) & (n_slots - 1)) {
        const int2 slot = table[s];
        if (slot.x == -1) break;
        if (slot.x != dj) continue;
        int e = slot.y;
        float* acc = mine + (e / Kq) * kTileRows;
        float v = *acc;
        do {                                // ascending i within the row
          v = __fadd_rn(v, __fmul_rn(qv[e], dval));
          e = chain[e];
        } while (e >= 0);
        *acc = v;
      }
    }
    for (int q = 0; q < qb; ++q)
      out[(size_t)(b0 + q) * N + r] = dead ? -INFINITY : mine[q * kTileRows];
  }
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

// Per-query rows: q_idx i64 [B, Kq], q_val f32 [B, Kq], db_idx i64
// [B, R, Kd], db_val f32 [B, R, Kd] -> out f32 [B, R].
extern "C" int sparse_dot_launch(const void* q_idx, const void* q_val,
                                 const void* db_idx, const void* db_val,
                                 void* out, int B, int R, int Kq, int Kd,
                                 int device, void* stream) {
  if (B == 0 || R == 0) return 0;
  return sel::on_device(device, [&]() -> cudaError_t {
    const dim3 grid((R + kThreads - 1) / kThreads, B);
    const size_t smem = (size_t)Kq * (sizeof(int) + sizeof(float));
    sparse_dot_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(q_idx), static_cast<const float*>(q_val),
        static_cast<const int*>(db_idx), static_cast<const float*>(db_val),
        static_cast<float*>(out), R, Kq, Kd);
    return cudaGetLastError();
  });
}

// Shared db: q_idx i64 [B, Kq], q_val f32 [B, Kq], db_idx i64 [N, Kd],
// db_val f32 [N, Kd], valid bool [N] or null -> out f32 [B, N] (-inf in
// the columns of rows that are not valid).
extern "C" int sparse_dot_shared_launch(const void* q_idx, const void* q_val,
                                        const void* db_idx,
                                        const void* db_val, const void* valid,
                                        void* out, int B, int N, int Kq,
                                        int Kd, int device, void* stream) {
  if (B == 0 || N == 0) return 0;
  return sel::on_device(device, [&]() -> cudaError_t {
    int log_slots = 1;                     // load factor <= 1/2
    while ((1 << log_slots) < 2 * kQueryChunk * Kq) ++log_slots;
    const size_t bytes = shared_smem_bytes(Kq, Kd, log_slots);
    static int granted[sel::kMaxDevices];
    cudaError_t err = sel::allow_smem(shared_dot_kernel, bytes, device,
                                      granted);
    if (err != cudaSuccess) return err;
    shared_dot_kernel<<<(N + kTileRows - 1) / kTileRows, kTileRows, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(q_idx), static_cast<const float*>(q_val),
        static_cast<const int*>(db_idx), static_cast<const float*>(db_val),
        static_cast<const bool*>(valid), static_cast<float*>(out), B, N, Kq,
        Kd, log_slots);
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
