// Fused pair-scorer MLP: sigmoid(tanh(tanh(x W0 + b0) W1 + b1) W2 + b2).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scorer_mlp.py::
// scorer_mlp (body _scorer_kernel). The TPU wrapper pads the hidden width
// to its 128-lane grain; here the kernel takes the unpadded width H.
//
// What bounds it on the H100: per launch, nothing the card is short of. At
// the main path's shape (160 pairs, F = 3, H = 10) it reads 2 KB and does
// about 40 K flops, so its time is the launch itself. At large batches it
// is bound by reading the F features of each row.
//
// Design: one thread per row. The weights (F*H + H*H + 2H + 1 floats) are
// staged in shared memory once per block; each thread keeps its row's
// hidden activations in registers (H <= kMaxHidden). tanhf and expf are the
// accurate library versions (no fast-math build flag), so the result stays
// within 1e-6 of the plain float32 version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHidden = 32;

__global__ void __launch_bounds__(kThreads)
scorer_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                  const float* __restrict__ b0, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ out,
                  int B, int F, int H) {
  extern __shared__ __align__(16) float wts[];
  float* w0_s = wts;                 // F x H
  float* b0_s = w0_s + F * H;        // H
  float* w1_s = b0_s + H;            // H x H
  float* b1_s = w1_s + H * H;        // H
  float* w2_s = b1_s + H;            // H
  float* b2_s = w2_s + H;            // 1
  for (int i = threadIdx.x; i < F * H; i += kThreads) w0_s[i] = w0[i];
  for (int i = threadIdx.x; i < H * H; i += kThreads) w1_s[i] = w1[i];
  for (int i = threadIdx.x; i < H; i += kThreads) {
    b0_s[i] = b0[i];
    b1_s[i] = b1[i];
    w2_s[i] = w2[i];
  }
  if (threadIdx.x == 0) b2_s[0] = b2[0];
  __syncthreads();

  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= B) return;
  const float* xr = x + (size_t)row * F;
  float h0[kMaxHidden];
  float h1[kMaxHidden];
  for (int j = 0; j < H; ++j) {
    float acc = 0.0f;
    for (int f = 0; f < F; ++f) acc += xr[f] * w0_s[f * H + j];
    h0[j] = tanhf(acc + b0_s[j]);
  }
  for (int j = 0; j < H; ++j) {
    float acc = 0.0f;
    for (int i = 0; i < H; ++i) acc += h0[i] * w1_s[i * H + j];
    h1[j] = tanhf(acc + b1_s[j]);
  }
  float logit = 0.0f;
  for (int i = 0; i < H; ++i) logit += h1[i] * w2_s[i];
  logit += b2_s[0];
  out[row] = 1.0f / (1.0f + expf(-logit));
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int scorer_mlp_max_hidden() { return kMaxHidden; }

extern "C" int scorer_mlp_launch(const void* x, const void* w0, const void* b0,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* out, int B, int F, int H,
                                 void* stream) {
  if (H > kMaxHidden) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)F * H + (size_t)H * H + 3 * H + 1);
  scorer_mlp_kernel<<<(B + kThreads - 1) / kThreads, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), B, F, H);
  return (int)cudaGetLastError();
}
