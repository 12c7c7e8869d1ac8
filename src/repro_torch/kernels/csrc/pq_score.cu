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
// and one float per query written, with M shared-memory gathers and adds
// between them; the tables are 8 KB a query at M = 8, C = 256.
//
// Design. A block of 256 candidates of one query would stage a whole table
// to score 2 KB of codes (16.8 MB of table reads for 4.2 MB of codes at
// B = 16, N = 32,768; 67 MB for 1 MB in the shared form, whose codes it
// would read once per query). Instead:
// - a block scores a run of candidates sized at launch so that the grid is
//   about four blocks per SM, and stages its tables once for the run;
// - in the shared form a block holds the tables of up to 48 KB worth of
//   queries (6 at 8 KB) and reads each code row once for all of them;
// - a candidate's codes are one 4-, 8- or 16-byte load where M is 4, 8 or
//   16 and the codes' address is aligned to M (chosen at launch), byte
//   loads otherwise;
// - consecutive threads take consecutive candidates: code loads and the
//   out[b, n] stores are coalesced; the table gathers hit shared memory.
//   Their banks are the codes, so a warp's gather of random codes takes
//   about 3.5 shared-memory wavefronts; at M = 8 that, not device memory,
//   sets the time.
// Sums use __fadd_rn: plain adds, which nvcc cannot contract with anything,
// in the subspace order of the plain version.
#include "select.cuh"

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr size_t kTableBytes = 48 * 1024;  // tables a shared-codes block holds

// VM = M when the codes come as one M-byte word a candidate, 0 for bytes.
template <int VM>
__global__ void __launch_bounds__(kThreads)
pq_score_kernel(const float* __restrict__ lut,
                const uint8_t* __restrict__ codes, float* __restrict__ out,
                int B, int N, int M, int C, long long codes_batch_rows,
                int queries, int run) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);  // queries x M x C
  const int b0 = blockIdx.y * queries;
  const int qt = min(queries, B - b0);
  const int mc = M * C;
  const float* src = lut + (size_t)b0 * mc;
  for (int i = threadIdx.x; i < qt * mc; i += kThreads) lut_s[i] = src[i];
  __syncthreads();
  const uint8_t* cb = codes + (size_t)b0 * codes_batch_rows * M;
  const int n1 = (int)min((long long)N, (long long)(blockIdx.x + 1) * run);
  for (int n = blockIdx.x * run + threadIdx.x; n < n1; n += kThreads) {
    const uint8_t* row = cb + (size_t)n * M;
    uint32_t w[VM > 0 ? VM / 4 : 1];
    if constexpr (VM == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(row);
    } else if constexpr (VM == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(row);
      w[0] = v.x;
      w[1] = v.y;
    } else if constexpr (VM == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    }
    for (int q = 0; q < qt; ++q) {
      const float* t = lut_s + q * mc;
      float acc = 0.0f;
      if constexpr (VM > 0) {
#pragma unroll
        for (int m = 0; m < VM; ++m) {
          const uint32_t code = (w[m >> 2] >> (8 * (m & 3))) & 0xFFu;
          acc = __fadd_rn(acc, t[m * C + code]);
        }
      } else {
        for (int m = 0; m < M; ++m) acc = __fadd_rn(acc, t[m * C + row[m]]);
      }
      out[(size_t)(b0 + q) * N + n] = acc;
    }
  }
}

template <int VM>
cudaError_t launch(const float* lut, const uint8_t* codes, float* out, int B,
                   int N, int M, int C, long long codes_batch_rows,
                   int queries, int run, int device, cudaStream_t stream) {
  static int granted[sel::kMaxDevices];
  const size_t bytes = sizeof(float) * (size_t)queries * M * C;
  cudaError_t err = sel::allow_smem(pq_score_kernel<VM>, bytes, device,
                                    granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + run - 1) / run, (B + queries - 1) / queries);
  pq_score_kernel<VM><<<grid, kThreads, bytes, stream>>>(
      lut, codes, out, B, N, M, C, codes_batch_rows, queries, run);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// lut f32 [B, M, C]; codes u8 with codes_batch_rows = N (per-query codes
// [B, N, M]) or 0 (shared codes [N, M]); out f32 [B, N].
extern "C" int pq_score_launch(const void* lut, const void* codes, void* out,
                               int B, int N, int M, int C,
                               long long codes_batch_rows, int device,
                               void* stream) {
  if (B == 0 || N == 0) return 0;
  if (M < 1 || C < 1 || device < 0 || device >= sel::kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  return sel::on_device(device, [&]() -> cudaError_t {
    static int sms[sel::kMaxDevices];
    if (sms[device] == 0) {
      const cudaError_t err = cudaDeviceGetAttribute(
          &sms[device], cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return err;
    }
    const size_t table = sizeof(float) * (size_t)M * C;
    int queries = 1;                 // per-query codes: one table a block
    if (codes_batch_rows == 0 && table < kTableBytes)
      queries = (int)std::min<size_t>(B, kTableBytes / table);
    const int groups = (B + queries - 1) / queries;
    // runs of whole thread strides, about kBlocksPerSm blocks an SM
    const int strides = (N + kThreads - 1) / kThreads;
    const int want = (kBlocksPerSm * sms[device] + groups - 1) / groups;
    const int per = std::max(1, std::min(strides, want));
    const int run = (strides + per - 1) / per * kThreads;
    const uintptr_t at = reinterpret_cast<uintptr_t>(codes);
    const int vm = (M == 4 || M == 8 || M == 16) && at % M == 0 ? M : 0;
    const float* l = static_cast<const float*>(lut);
    const uint8_t* c = static_cast<const uint8_t*>(codes);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (vm) {
      case 4: return launch<4>(l, c, o, B, N, M, C, codes_batch_rows,
                               queries, run, device, s);
      case 8: return launch<8>(l, c, o, B, N, M, C, codes_batch_rows,
                               queries, run, device, s);
      case 16: return launch<16>(l, c, o, B, N, M, C, codes_batch_rows,
                                 queries, run, device, s);
      default: return launch<0>(l, c, o, B, N, M, C, codes_batch_rows,
                                queries, run, device, s);
    }
  });
}
