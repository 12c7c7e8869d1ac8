// Fused pair-scorer MLP: sigmoid(tanh(tanh(x W0 + b0) W1 + b1) W2 + b2).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scorer_mlp.py::
// scorer_mlp (body _scorer_kernel). The TPU wrapper pads the hidden width
// to its 128-lane grain; here the kernels take the unpadded width H.
//
// Two kernels share the MLP (mlp_forward) and its weights staged once per
// block in shared memory:
//   * scorer_mlp_kernel, the TPU kernel's counterpart: features given, one
//     thread per row;
//   * pair_score_kernel, scorer_mlp redesigned with what precedes it on
//     the serving path (src/repro/core/scorer.py:37-62, pair_features):
//     one warp per pair computes the pair's features from the raw feature
//     rows, then its lane 0 runs the MLP. Pair p compares candidate row p
//     with query row p / group, so a query's rows are read once per
//     candidate from the query arrays and never repeated in memory.
//
// Features, in pair_features' order (groups as the caller lays them out):
//   dense group of width D: cosine = a.b / (na nb), scaled L2 =
//     -|a - b| / (na + nb), with na = |a| + 1e-9, nb = |b| + 1e-9; one pass
//     over D, lane l taking elements l, l + 32, ... (coalesced loads), the
//     four sums (a.b, |a|^2, |b|^2, |a-b|^2) reduced with __shfl_xor_sync;
//   set group of L items (int32, PAD_ITEM = -1 absent): inter = the number
//     of (i, j) with a_i == b_j, both present; Jaccard = inter / max(|a| +
//     |b| - inter, 1) and log1p(inter); lane l holds a_l and compares it
//     with b's items broadcast by shuffles (L x L compares per pair);
//   scalar: -|a - b|.
// The sums run in another order than torch's reductions, so the check
// against the plain version is allclose (rtol 1e-5, atol 1e-6).
//
// What bounds it on the H100: per launch, nothing the card is short of. At
// the serving path's shapes (160 pairs of 128 floats, F = 3, H = 10) it
// reads about 90 KB and does about 0.2 MFLOP, below a launch's worth of
// work: its time is the launch and one dependent read per pair. At large
// batches it is bound by reading the candidates' feature rows. tanhf, expf,
// sqrtf and log1pf are the accurate library versions (no fast-math build
// flag).
#include "select.cuh"   // sel::on_device

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHidden = 32;
constexpr int kMaxGroups = 8;
constexpr int kMaxFeatures = 2 * kMaxGroups;
constexpr int kPairWarps = 8;               // pairs a block
constexpr int kDense = 0, kSet = 1, kScalar = 2;
constexpr int kPadItem = -1;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Weights {
  const float* w0;   // F x H
  const float* b0;   // H
  const float* w1;   // H x H
  const float* b1;   // H
  const float* w2;   // H
  const float* b2;   // 1
};

size_t weight_floats(int F, int H) {
  return (size_t)F * H + (size_t)H * H + 3 * (size_t)H + 1;
}

// Copies the weights into shared memory `wts`; the caller syncs.
__device__ Weights stage_weights(float* wts, const Weights& g, int F, int H) {
  Weights s;
  float* w0 = wts;
  float* b0 = w0 + F * H;
  float* w1 = b0 + H;
  float* b1 = w1 + H * H;
  float* w2 = b1 + H;
  float* b2 = w2 + H;
  for (int i = threadIdx.x; i < F * H; i += blockDim.x) w0[i] = g.w0[i];
  for (int i = threadIdx.x; i < H * H; i += blockDim.x) w1[i] = g.w1[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    b0[i] = g.b0[i];
    b1[i] = g.b1[i];
    w2[i] = g.w2[i];
  }
  if (threadIdx.x == 0) b2[0] = g.b2[0];
  s.w0 = w0; s.b0 = b0; s.w1 = w1; s.b1 = b1; s.w2 = w2; s.b2 = b2;
  return s;
}

// F -> H -> H -> 1 for one row x, from weights in shared memory.
__device__ float mlp_forward(const float* x, const Weights& w, int F, int H) {
  float h0[kMaxHidden];
  float h1[kMaxHidden];
  for (int j = 0; j < H; ++j) {
    float acc = 0.0f;
    for (int f = 0; f < F; ++f) acc += x[f] * w.w0[f * H + j];
    h0[j] = tanhf(acc + w.b0[j]);
  }
  for (int j = 0; j < H; ++j) {
    float acc = 0.0f;
    for (int i = 0; i < H; ++i) acc += h0[i] * w.w1[i * H + j];
    h1[j] = tanhf(acc + w.b1[j]);
  }
  float logit = 0.0f;
  for (int i = 0; i < H; ++i) logit += h1[i] * w.w2[i];
  logit += w.b2[0];
  return 1.0f / (1.0f + expf(-logit));
}

__global__ void __launch_bounds__(kThreads)
scorer_mlp_kernel(const float* __restrict__ x, Weights g,
                  float* __restrict__ out, int B, int F, int H) {
  extern __shared__ __align__(16) float wts[];
  const Weights w = stage_weights(wts, g, F, H);
  __syncthreads();
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= B) return;
  out[row] = mlp_forward(x + (size_t)row * F, w, F, H);
}

// The feature groups of a pair, by value in the kernel's parameters.
struct Groups {
  const void* q[kMaxGroups];   // [Q, dim] (scalar: [Q])
  const void* c[kMaxGroups];   // [P, dim] (scalar: [P])
  int kind[kMaxGroups];
  int dim[kMaxGroups];
  int n;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kPairWarps * 32)
pair_score_kernel(Groups g, Weights wg, float* __restrict__ out, int P,
                  int group, int F, int H) {
  extern __shared__ __align__(16) float wts[];
  __shared__ float feats_s[kPairWarps][kMaxFeatures];
  const Weights w = stage_weights(wts, wg, F, H);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kPairWarps + warp;
  if (p >= P) return;                       // the whole warp
  const size_t qrow = p / group;
  float* x = feats_s[warp];
  int f = 0;
  for (int gi = 0; gi < g.n; ++gi) {
    const int d = g.dim[gi];
    if (g.kind[gi] == kDense) {
      const float* a = static_cast<const float*>(g.q[gi]) + qrow * d;
      const float* b = static_cast<const float*>(g.c[gi]) + (size_t)p * d;
      float ab = 0.0f, aa = 0.0f, bb = 0.0f, dd = 0.0f;
      for (int i = lane; i < d; i += 32) {
        const float u = a[i], v = b[i], t = u - v;
        ab += u * v;
        aa += u * u;
        bb += v * v;
        dd += t * t;
      }
      ab = warp_sum(ab);
      aa = warp_sum(aa);
      bb = warp_sum(bb);
      dd = warp_sum(dd);
      if (lane == 0) {
        const float na = sqrtf(aa) + 1e-9f, nb = sqrtf(bb) + 1e-9f;
        x[f] = ab / (na * nb);
        x[f + 1] = -sqrtf(dd) / (na + nb);
      }
      f += 2;
    } else if (g.kind[gi] == kSet) {
      const int* a = static_cast<const int*>(g.q[gi]) + qrow * d;
      const int* b = static_cast<const int*>(g.c[gi]) + (size_t)p * d;
      int inter = 0, size_a = 0, size_b = 0;
      for (int j0 = 0; j0 < d; j0 += 32) {
        const int bj = j0 + lane < d ? b[j0 + lane] : kPadItem;
        size_b += __popc(__ballot_sync(kFull, bj != kPadItem));
      }
      for (int i0 = 0; i0 < d; i0 += 32) {
        const int ai = i0 + lane < d ? a[i0 + lane] : kPadItem;
        size_a += __popc(__ballot_sync(kFull, ai != kPadItem));
        for (int j0 = 0; j0 < d; j0 += 32) {
          const int bj = j0 + lane < d ? b[j0 + lane] : kPadItem;
          const int m = min(32, d - j0);
          for (int t = 0; t < m; ++t) {
            const int v = __shfl_sync(kFull, bj, t);
            inter += (ai != kPadItem && ai == v);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        inter += __shfl_xor_sync(kFull, inter, off);
      if (lane == 0) {
        const float fi = static_cast<float>(inter);
        const float uni = fmaxf(static_cast<float>(size_a)
                                + static_cast<float>(size_b) - fi, 1.0f);
        x[f] = fi / uni;
        x[f + 1] = log1pf(fi);
      }
      f += 2;
    } else {
      if (lane == 0) {
        x[f] = -fabsf(static_cast<const float*>(g.q[gi])[qrow]
                      - static_cast<const float*>(g.c[gi])[p]);
      }
      f += 1;
    }
  }
  __syncwarp();
  if (lane == 0) out[p] = mlp_forward(x, w, F, H);
}

Weights weights_of(const void* w0, const void* b0, const void* w1,
                   const void* b1, const void* w2, const void* b2) {
  return Weights{static_cast<const float*>(w0), static_cast<const float*>(b0),
                 static_cast<const float*>(w1), static_cast<const float*>(b1),
                 static_cast<const float*>(w2), static_cast<const float*>(b2)};
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The kernels' limits, read once by the wrapper: hidden width, feature
// groups of a pair.
extern "C" int scorer_mlp_max_hidden() { return kMaxHidden; }
extern "C" int pair_score_max_groups() { return kMaxGroups; }

extern "C" int scorer_mlp_launch(const void* x, const void* w0, const void* b0,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* out, int B, int F, int H,
                                 int device, void* stream) {
  if (H > kMaxHidden) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return sel::on_device(device, [&]() -> cudaError_t {
    scorer_mlp_kernel<<<(B + kThreads - 1) / kThreads, kThreads,
                        sizeof(float) * weight_floats(F, H),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), weights_of(w0, b0, w1, b1, w2, b2),
        static_cast<float*>(out), B, F, H);
    return cudaGetLastError();
  });
}

// q_ptrs / c_ptrs: the groups' query [Q, dim] and candidate [P, dim]
// arrays (f32 dense and scalar, i32 sets), kinds 0 dense, 1 set, 2
// scalar; P = Q * group -> out f32 [P]. One launch.
extern "C" int pair_score_launch(const void* const* q_ptrs,
                                 const void* const* c_ptrs, const int* kinds,
                                 const int* dims, int n_groups,
                                 const void* w0, const void* b0,
                                 const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out,
                                 int P, int group, int F, int H, int device,
                                 void* stream) {
  if (n_groups < 0 || n_groups > kMaxGroups || H > kMaxHidden || group < 1)
    return (int)cudaErrorInvalidValue;
  Groups g{};
  int n_feats = 0;
  for (int i = 0; i < n_groups; ++i) {
    if (kinds[i] < kDense || kinds[i] > kScalar)
      return (int)cudaErrorInvalidValue;
    g.q[i] = q_ptrs[i];
    g.c[i] = c_ptrs[i];
    g.kind[i] = kinds[i];
    g.dim[i] = dims[i];
    n_feats += kinds[i] == kScalar ? 1 : 2;
  }
  g.n = n_groups;
  if (n_feats != F) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  return sel::on_device(device, [&]() -> cudaError_t {
    pair_score_kernel<<<(P + kPairWarps - 1) / kPairWarps, kPairWarps * 32,
                        sizeof(float) * weight_floats(F, H),
                        static_cast<cudaStream_t>(stream)>>>(
        g, weights_of(w0, b0, w1, b1, w2, b2), static_cast<float*>(out), P,
        group, F, H);
    return cudaGetLastError();
  });
}
