// PQ lookup-table scoring: the sum over subspaces of each candidate's
// table entries, taken in order.
//
// Replaces two Pallas TPU kernels with one CUDA kernel:
//   src/repro/kernels/pq_score.py::pq_score_batched (codes per query,
//     [B, N, M]: the fused=False shortlist), and
//   src/repro/kernels/pq_score.py::pq_score (codes shared by every query,
//     [N, M]).
// Both have the body _pq_score_kernel, a one-hot matmul per subspace on
// the TPU's matrix unit; the one-hot rows add exact zeros, so the result
// is the ordered gather-sum
//   out[b, n] = ((0 + lut[b][0][c0]) + lut[b][1][c1]) + ...
// The shared form is the batched one with a codes batch stride of 0.
//
// What bounds it on the H100: bytes. Each candidate's M code bytes are read
// and one float written, with M adds between them; a query's table (M x C
// floats, 8 KB at M=8, C=256) is read once per block. In the shared form
// the codes (1 MB at N=131,072, M=8) are read once per query row of the
// grid, mostly from L2.
//
// Design: grid (ceil(N / 256), B), one thread per (query, candidate). The
// block stages its query's table in shared memory, so the code gathers hit
// shared memory. Sums use __fadd_rn: plain adds, which nvcc cannot contract
// with anything, in the subspace order of the plain version.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pq_score_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                float* __restrict__ out, int N, int M, int C,
                long long codes_batch_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);              // M*C
  const int b = blockIdx.y;
  const float* lut_row = lut + (size_t)b * M * C;
  for (int i = threadIdx.x; i < M * C; i += kThreads) lut_s[i] = lut_row[i];
  __syncthreads();
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const uint8_t* c = codes + ((size_t)b * codes_batch_rows + n) * M;
  float acc = 0.0f;
  for (int m = 0; m < M; ++m) acc = __fadd_rn(acc, lut_s[m * C + c[m]]);
  out[(size_t)b * N + n] = acc;
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// lut f32 [B, M, C]; codes u8 with codes_batch_rows = N (per-query codes
// [B, N, M]) or 0 (shared codes [N, M]); out f32 [B, N].
extern "C" int pq_score_launch(const void* lut, const void* codes, void* out,
                               int B, int N, int M, int C,
                               long long codes_batch_rows, void* stream) {
  if (B == 0 || N == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)M * C;
  if (smem > 48 * 1024) {
    int dev = 0, limit = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        pq_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  pq_score_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<float*>(out), N, M, C, codes_batch_rows);
  return (int)cudaGetLastError();
}
