// Exact sparse-sparse dot products over fixed-nnz padded rows.
//
// Replaces two Pallas TPU kernels with one CUDA kernel:
//   src/repro/kernels/sparse_dot.py::sparse_dot_batched (per-query rows,
//     db [B, R, Kd]: the shortlist rescore), and
//   src/repro/kernels/sparse_dot.py::sparse_dot (one db shared by every
//     query, db [N, Kd]: the exact brute-force index).
// Both have the body _sparse_dot_kernel: out[b, r] = sum over index pairs
// (i, j) with q_idx[b, i] == db_idx[r, j] != PAD_INDEX of q_val * db_val.
// The shared form is the batched one with a db batch stride of 0.
//
// Indices are uint32 values stored in int64 tensors. The kernel reads the
// low 32-bit word of each (the tensor viewed as int32, stride 2): the high
// word is always 0, so equality of low words is equality of the indices,
// and PAD_INDEX becomes -1.
//
// What bounds it on the H100: bytes. Each db row (Kd 8-byte indices and Kd
// float values) is read once per query and takes Kq x Kd integer compares;
// at Kq = Kd = 9 that is 81 compares per 108 bytes, far below the compute
// rate. In the shared form the db is read once per query row of the grid;
// a 262,144-row db of K = 9 is 28 MB, inside the 50 MB L2, so the repeats
// mostly hit L2.
//
// Design: grid (ceil(R / 256), B), one thread per (query, db row). The
// block's query row (indices and values) is staged in shared memory; each
// thread walks its db row once, comparing every entry against the query
// row. Products and sums are rounded separately (no fused multiply-add),
// as the reference rounds them.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

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
  float acc = 0.0f;
  for (int j = 0; j < Kd; ++j) {
    const int dj = db_idx[2 * (row + j)];
    const float dv = db_val[row + j];
    for (int i = 0; i < Kq; ++i) {
      const int qi = qi_s[i];
      if (qi == dj && qi != -1) acc = __fadd_rn(acc, __fmul_rn(qv_s[i], dv));
    }
  }
  out[(size_t)b * R + r] = acc;
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
                                 long long db_batch_rows, void* stream) {
  if (B == 0 || R == 0) return 0;
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  const size_t smem = (size_t)Kq * (sizeof(int) + sizeof(float));
  sparse_dot_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q_idx), static_cast<const float*>(q_val),
      static_cast<const int*>(db_idx), static_cast<const float*>(db_val),
      static_cast<float*>(out), R, Kq, Kd, db_batch_rows);
  return (int)cudaGetLastError();
}
