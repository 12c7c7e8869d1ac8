// LSH bucket-ID columns: the uint32 hashing of core/buckets.py::
// generate_buckets after the SimHash projection, in two launches.
//
// Replaces no Pallas TPU kernel: the JAX package computes these columns
// with XLA's elementwise uint32 ops (src/repro/core/buckets.py). The plain
// PyTorch version emulates uint32 in int64, about 27 small elementwise
// kernels for each column's hash_fields and 56 for each MinHash table,
// which made them most of the neighborhood RPC's launches.
//
// Two kernels, each launched once per call whatever the number of modes
// (the modes' arrays come as a struct of pointers and strides):
//   simhash_scalar_kernel: every SimHash column (the sign bits of a
//     table's projection packed into a code, bit k = proj[k] > 0, then
//     hash_fields) and every scalar column (floor(x / width) in float32,
//     cast to int32 as PyTorch's CUDA cast does, then hash_fields); one
//     thread per (row, column);
//   minhash_kernel: every MinHash table of every set mode; one thread per
//     (row, set mode) loads the row's items once for up to kTableChunk
//     tables and keeps each table's minimum of uhash over the present
//     items (PAD_ITEM = -1 absent). A row without an item keeps the
//     minimum's start, 0xFFFFFFFF, as the plain version's masked min does,
//     and its valid flag is false.
// hash_fields(tag, t, v) = combine(combine(combine(0x811C9DC5, tag), t), v);
// the first two combines are a per-column constant computed on the host
// (`prefix`), as is each table's fmix32(seed * 131 + t) (`seed_mix`). Every
// product and sum is native uint32 arithmetic, so the ids are bitwise the
// plain version's.
//
// What bounds it on the H100: nothing at the serving path's shapes (16
// rows, 9-14 columns): its time is the launch. At a bootstrap's 1.47M rows
// it is bound by bytes, the projections read once (dense_bits floats per
// SimHash column) and 9 bytes written per column; the hashing is a few
// dozen integer operations per column. Indices are 64-bit and the loops
// grid-stride, so any row count runs on a capped grid.
#include "hash.cuh"     // hashing::fmix32, hashing::kGolden
#include "select.cuh"   // sel::on_device, sel::kMaxDevices

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;
constexpr int kMaxModes = 16;       // modes of one kind a launch takes
constexpr int kTableChunk = 8;      // MinHash tables a pass over a row's items
constexpr int kPadItem = -1;
using hashing::fmix32;
using hashing::kGolden;

// The arrays of one kind of mode: dense projections f32 [T, B, bits]
// (strides table, row, bit), set items i32 [B, cap] (strides row, item;
// width = cap) or scalars f32 [B] (stride row).
struct Modes {
  const void* ptr[kMaxModes];
  long long stride[kMaxModes][3];
  int width[kMaxModes];
  int n;
};

__device__ __forceinline__ uint32_t combine(uint32_t h, uint32_t v) {
  return fmix32(h ^ (v + kGolden + (h << 6) + (h >> 2)));
}

__global__ void __launch_bounds__(kThreads)
simhash_scalar_kernel(Modes dense, Modes scalars, int tables, int bits,
                      int widths, int scalar_col0,
                      const uint32_t* __restrict__ prefix,
                      const float* __restrict__ width,
                      long long B, int k_max, long long* __restrict__ ids,
                      bool* __restrict__ valid) {
  const int dense_cols = dense.n * tables;
  const int cols = dense_cols + scalars.n * widths;
  const long long total = B * cols;
  const int code_bits = bits < 32 ? bits : 32;   // _u32 keeps bits 0-31
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    const long long b = i / cols;
    const int c = (int)(i - b * cols);
    int col;
    uint32_t value;
    if (c < dense_cols) {
      const int m = c / tables, t = c - m * tables;
      const long long* st = dense.stride[m];
      const float* p = static_cast<const float*>(dense.ptr[m]) + t * st[0]
                       + b * st[1];
      value = 0;
      for (int k = 0; k < code_bits; ++k)
        value |= (p[k * st[2]] > 0.0f ? 1u : 0u) << k;
      col = c;
    } else {
      const int s = c - dense_cols, m = s / widths, w = s - m * widths;
      const float x = static_cast<const float*>(scalars.ptr[m])[
          b * scalars.stride[m][0]];
      // float -> int32 saturates and takes NaN to 0 (cvt.rzi.s32.f32)
      value = static_cast<uint32_t>(
          static_cast<int>(floorf(__fdiv_rn(x, width[w]))));
      col = scalar_col0 + s;
    }
    const long long out = b * k_max + col;
    ids[out] = static_cast<long long>(combine(prefix[col], value));
    valid[out] = true;
  }
}

__global__ void __launch_bounds__(kThreads)
minhash_kernel(Modes sets, int tables, int set_col0,
               const uint32_t* __restrict__ prefix,
               const uint32_t* __restrict__ seed_mix, long long B, int k_max,
               long long* __restrict__ ids, bool* __restrict__ valid) {
  const long long total = B * sets.n;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    const long long b = i / sets.n;
    const int m = (int)(i - b * sets.n);
    const long long* st = sets.stride[m];
    const int* row = static_cast<const int*>(sets.ptr[m]) + b * st[0];
    const int cap = sets.width[m];
    const int col0 = set_col0 + m * tables;
    for (int t0 = 0; t0 < tables; t0 += kTableChunk) {
      uint32_t mix[kTableChunk], low[kTableChunk];
#pragma unroll
      for (int u = 0; u < kTableChunk; ++u) {
        mix[u] = t0 + u < tables ? seed_mix[t0 + u] : 0u;
        low[u] = 0xFFFFFFFFu;
      }
      bool any = false;
      for (int j = 0; j < cap; ++j) {
        const int item = row[j * st[1]];
        if (item == kPadItem) continue;
        any = true;
        const uint32_t x = static_cast<uint32_t>(item) * kGolden;
#pragma unroll
        for (int u = 0; u < kTableChunk; ++u)
          low[u] = min(low[u], fmix32(x ^ mix[u]));
      }
#pragma unroll
      for (int u = 0; u < kTableChunk; ++u) {
        if (t0 + u >= tables) break;
        const int col = col0 + t0 + u;
        const long long out = b * k_max + col;
        ids[out] = static_cast<long long>(combine(prefix[col], low[u]));
        valid[out] = any;
      }
    }
  }
}

// Fills a Modes from the caller's arrays; false if there are too many.
bool gather_modes(Modes* modes, const void* const* ptrs,
                  const long long* strides, const int* widths, int n) {
  if (n < 0 || n > kMaxModes) return false;
  *modes = Modes{};
  modes->n = n;
  for (int m = 0; m < n; ++m) {
    modes->ptr[m] = ptrs[m];
    for (int s = 0; s < 3; ++s) modes->stride[m][s] = strides[3 * m + s];
    modes->width[m] = widths ? widths[m] : 0;
  }
  return true;
}

int blocks_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int buckets_max_modes() { return kMaxModes; }

// dense: n_dense projections f32 [tables, B, bits]; scalars: n_scalar f32
// [B]; strides: three per mode (table, row, bit; a scalar's row first).
// Writes columns [0, n_dense * tables) and [scalar_col0, scalar_col0 +
// n_scalar * widths) of ids i64 [B, k_max] and valid bool [B, k_max].
extern "C" int simhash_scalar_launch(
    const void* const* dense, const long long* dense_strides, int n_dense,
    int tables, int bits, const void* const* scalars,
    const long long* scalar_strides, int n_scalar, int widths,
    int scalar_col0, const void* prefix, const void* width, long long B,
    int k_max, void* ids, void* valid, int device, void* stream) {
  Modes d, s;
  if (!gather_modes(&d, dense, dense_strides, nullptr, n_dense)
      || !gather_modes(&s, scalars, scalar_strides, nullptr, n_scalar)
      || tables < 0 || bits < 0 || widths < 0 || B < 0
      || device < 0 || device >= sel::kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const long long work = B * (n_dense * tables + n_scalar * widths);
  if (work == 0) return 0;
  return sel::on_device(device, [&]() -> cudaError_t {
    simhash_scalar_kernel<<<blocks_for(work), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        d, s, tables, bits, widths, scalar_col0,
        static_cast<const uint32_t*>(prefix),
        static_cast<const float*>(width), B, k_max,
        static_cast<long long*>(ids), static_cast<bool*>(valid));
    return cudaGetLastError();
  });
}

// sets: n_set items i32 [B, caps[m]], strides three per mode (row, item,
// unused). Writes columns [set_col0, set_col0 + n_set * tables).
extern "C" int minhash_launch(
    const void* const* sets, const long long* set_strides, const int* caps,
    int n_set, int tables, int set_col0, const void* prefix,
    const void* seed_mix, long long B, int k_max, void* ids, void* valid,
    int device, void* stream) {
  Modes m;
  if (!gather_modes(&m, sets, set_strides, caps, n_set) || tables < 0
      || B < 0 || device < 0 || device >= sel::kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const long long work = tables > 0 ? B * n_set : 0;
  if (work == 0) return 0;
  return sel::on_device(device, [&]() -> cudaError_t {
    minhash_kernel<<<blocks_for(work), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        m, tables, set_col0, static_cast<const uint32_t*>(prefix),
        static_cast<const uint32_t*>(seed_mix), B, k_max,
        static_cast<long long*>(ids), static_cast<bool*>(valid));
    return cudaGetLastError();
  });
}
