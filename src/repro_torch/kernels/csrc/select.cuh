// Block-level top-k selection shared by topk_select.cu and fused_query.cu.
//
// Order. Every entry becomes a unique 64-bit key, larger = earlier:
//   high word: the order-preserving image of the f32 value (bits | sign bit
//              for a positive value, ~bits for a negative one), with -0.0
//              read as +0.0 when the caller ties signed zeros;
//   low word:  ~index, so the lower index wins between equal values.
// Sorting keys in descending order is "value descending, lowest index at
// ties" (-inf included), and a key gives back its index and its value.
// Key 0 is never a real key (it would need index 0xFFFFFFFF): it pads.
//
// A long row is split into chunks of S entries. A block selects its
// chunk's top-min(k, len) keys; the survivors of all chunks are laid end
// to end (only the last chunk can hold fewer than min(k, S)) and split
// again, while the row is longer than one chunk, and the block that holds
// a whole row writes the answer. This is exact: the row's top-k lies in
// the union of the chunks' top-k, because the chunks partition the row.
// With S >= 2k every level at least halves the row. Above that (k > S/2
// on a row of more than one chunk) a level of chunks would not shrink the
// row, so the first level's sorted runs are merged pairwise in device
// memory instead (merge_runs): each merge keeps the top min(k, |a| + |b|)
// keys of its two runs, and the levels repeat until one run is left,
// ceil(log2(chunks)) launches. A merge-path split gives every block an
// equal share of one output run: two binary searches find where the
// block's first and last outputs cut the two runs, the block stages that
// stretch of each in shared memory, and each thread finds its own start
// the same way and merges a few outputs sequentially.
//
// In a block: a radix select finds the threshold T with exactly m keys
// >= T (8-bit digits from the top, a shared-memory histogram per digit,
// warp-aggregated with __match_any_sync because many keys share the high
// bytes of their value; it stops at the first digit whose bin is taken
// whole), a ballot compaction gathers those m keys, and a bitonic sort in
// shared memory orders them. Work O(len) plus O(m log^2 m), a few dozen
// block barriers, no global scratch inside a block.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace sel {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint64_t make_key(float v, int idx,
                                             bool tie_zeros) {
  uint32_t b = __float_as_uint(v);
  if (tie_zeros && b == 0x80000000u) b = 0u;
  const uint32_t img = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<uint64_t>(img) << 32) | static_cast<uint32_t>(~idx);
}

__device__ __forceinline__ float key_value(uint64_t key) {
  const uint32_t img = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((img & 0x80000000u) ? (img & 0x7FFFFFFFu) : ~img);
}

__device__ __forceinline__ int key_index(uint64_t key) {
  return static_cast<int>(~static_cast<uint32_t>(key));
}

__host__ __device__ __forceinline__ int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The shared memory of a selecting block: the chunk's keys, the sorted
// survivors, the digit histogram, a few scalars, then what the caller adds.
struct Smem {
  uint64_t* keys;    // cap_n
  uint64_t* surv;    // cap_p = pow2_ceil(min(k, cap_n))
  unsigned* hist;    // 256
  unsigned* scal;    // 8
  unsigned char* extra;
};

__host__ __device__ inline size_t smem_bytes(int cap_n, int cap_p) {
  return sizeof(uint64_t) * (static_cast<size_t>(cap_n) + cap_p)
         + sizeof(unsigned) * (256 + 8);
}

__device__ inline Smem carve(unsigned char* base, int cap_n, int cap_p) {
  Smem s;
  s.keys = reinterpret_cast<uint64_t*>(base);
  s.surv = s.keys + cap_n;
  s.hist = reinterpret_cast<unsigned*>(s.surv + cap_p);
  s.scal = s.hist + 256;
  s.extra = reinterpret_cast<unsigned char*>(s.scal + 8);
  return s;
}

// Sorts a[0..p) (p a power of two) in descending order. Whole block.
__device__ inline void bitonic_desc(uint64_t* a, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const uint64_t x = a[i], y = a[j];
        const bool desc = (i & size) == 0;
        if (desc ? x < y : x > y) { a[i] = y; a[j] = x; }
      }
      __syncthreads();
    }
  }
}

// The m largest of s.keys[0..n) (unique keys, 1 <= m <= n) into
// s.surv[0..m), in descending order; s.surv[m..pow2_ceil(m)) hold 0.
// Whole block; blockDim.x a multiple of 32; ends after a barrier.
__device__ inline void select_top(const Smem& s, int n, int m) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint64_t thresh = 0;                 // keep the keys >= thresh
  if (m < n) {
    uint64_t prefix = 0, mask = 0;
    unsigned rem = static_cast<unsigned>(m);
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += blockDim.x) s.hist[i] = 0;
      __syncthreads();
      for (int b0 = 0; b0 < n; b0 += blockDim.x) {
        const int i = b0 + tid;
        unsigned d = 256;              // 256: not under the prefix
        if (i < n) {
          const uint64_t key = s.keys[i];
          if ((key & mask) == prefix)
            d = static_cast<unsigned>(key >> shift) & 0xFFu;
        }
        const unsigned peers = __match_any_sync(kFull, d);
        if (d != 256 && lane == __ffs(peers) - 1)
          atomicAdd(&s.hist[d], __popc(peers));
      }
      __syncthreads();
      if (tid < 32) {
        // lane l holds bins 255-8l down to 248-8l; count above each bin
        unsigned c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = s.hist[255 - 8 * lane - j];
          sum += c[j];
        }
        unsigned incl = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned t = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += t;
        }
        unsigned above = incl - sum;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above < rem && above + c[j] >= rem) {
            s.scal[0] = 255 - 8 * lane - j;
            s.scal[1] = rem - above;
            s.scal[2] = c[j];
          }
          above += c[j];
        }
      }
      __syncthreads();
      const unsigned d = s.scal[0];
      rem = s.scal[1];
      prefix |= static_cast<uint64_t>(d) << shift;
      mask |= static_cast<uint64_t>(0xFFu) << shift;
      if (s.scal[2] == rem) break;     // the whole bin is in: T = prefix
    }
    thresh = prefix;
  }
  if (tid == 0) s.scal[3] = 0;
  __syncthreads();
  for (int b0 = 0; b0 < n; b0 += blockDim.x) {
    const int i = b0 + tid;
    const bool take = i < n && s.keys[i] >= thresh;
    const unsigned bal = __ballot_sync(kFull, take);
    unsigned base = 0;
    if (lane == 0 && bal != 0) base = atomicAdd(&s.scal[3], __popc(bal));
    base = __shfl_sync(kFull, base, 0);
    if (take) s.surv[base + __popc(bal & ((1u << lane) - 1u))] = s.keys[i];
  }
  const int p = pow2_ceil(m);
  for (int i = m + tid; i < p; i += blockDim.x) s.surv[i] = 0;
  __syncthreads();
  bitonic_desc(s.surv, p);
}

// One level of the split on keys already made: block (chunk, row) of
// grid chunks x B selects its chunk of in[row][0..n_row) and either
// writes its survivors to out[row][chunk * m0 ..] (rows of n_out) or,
// when the row is one chunk, hands them to the caller's final step.
template <class Final>
__global__ void __launch_bounds__(kThreads)
keys_level_kernel(const uint64_t* __restrict__ in, int n_row, int chunks,
                  uint64_t* __restrict__ out, int n_out, int k, int S,
                  Final fin) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = blockIdx.x % chunks;
  const int row = blockIdx.x / chunks;
  const int lo = chunk * S;
  const int n = min(S, n_row - lo);
  const int m = min(k, n);
  const int cap_n = min(S, n_row);
  const Smem s = carve(smem, cap_n, pow2_ceil(min(k, cap_n)));
  const uint64_t* src = in + static_cast<size_t>(row) * n_row + lo;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s.keys[i] = src[i];
  __syncthreads();
  select_top(s, n, m);
  if (chunks == 1) {
    fin(row, s);
    return;
  }
  uint64_t* dst = out + static_cast<size_t>(row) * n_out
                  + static_cast<size_t>(chunk) * min(k, S);
  for (int i = threadIdx.x; i < m; i += blockDim.x) dst[i] = s.surv[i];
}

// Row length after one level of the split.
__host__ __device__ inline int level_out(int n, int k, int S) {
  const int chunks = (n + S - 1) / S;
  const int last = n - (chunks - 1) * S;
  return (chunks - 1) * (k < S ? k : S) + (k < last ? k : last);
}

// Opt in to more than 48 KB of dynamic shared memory once per kernel and
// device: `cache` (one per kernel instance) remembers what was granted.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes, int device, int* cache) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (static_cast<size_t>(cache[device]) >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) cache[device] = static_cast<int>(bytes);
  return err;
}

// Merges level after level from `keys` (rows of n, made by the caller's
// first level) until one block holds each row and calls `fin`. `keys` and
// `other` are ping-pong buffers of B x n keys at least.
template <class Final>
cudaError_t merge_levels(uint64_t* keys, uint64_t* other, int B, int n,
                         int k, int S, Final fin, int device,
                         cudaStream_t stream) {
  static int granted[kMaxDevices];
  for (;;) {
    const int chunks = (n + S - 1) / S;
    const int n_out = level_out(n, k, S);
    const int cap_n = n < S ? n : S;
    const size_t bytes = smem_bytes(cap_n, pow2_ceil(k < cap_n ? k : cap_n));
    cudaError_t err = allow_smem(keys_level_kernel<Final>, bytes, device,
                                 granted);
    if (err != cudaSuccess) return err;
    keys_level_kernel<Final><<<chunks * B, kThreads, bytes, stream>>>(
        keys, n, chunks, other, n_out, k, S, fin);
    err = cudaGetLastError();
    if (err != cudaSuccess || chunks == 1) return err;
    uint64_t* t = keys;
    keys = other;
    other = t;
    n = n_out;
  }
}

// ---- The pairwise merge in device memory (2k > S).

constexpr int kMergeItems = 4;                      // outputs a thread
constexpr int kMergeTile = kThreads * kMergeItems;  // outputs a block

// One level's sorted runs, laid out alike in every row: `count` runs at a
// stride of `len`, all `len` long but the last (`last`).
struct Runs {
  int count;
  int len;
  int last;

  __host__ __device__ int row_len() const { return (count - 1) * len + last; }
  __host__ __device__ int length(int r) const {
    return r == count - 1 ? last : len;
  }
  // The runs after one pairwise merge that keeps the top k of each pair
  // (a lone last run is carried over as it is).
  __host__ Runs merged(int k) const {
    Runs o;
    o.count = (count + 1) / 2;
    o.last = count % 2 ? last : (k < len + last ? k : len + last);
    o.len = o.count == 1 ? o.last : (k < 2 * len ? k : 2 * len);
    return o;
  }
};

// How many of the first d keys of the merge of a (na keys) and b (nb),
// both descending and with no key in both, come from a.
__device__ __forceinline__ int merge_split(const uint64_t* a, int na,
                                           const uint64_t* b, int nb,
                                           int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > b[d - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Block (tile, pair, row): outputs [tile * kMergeTile, +kMergeTile) of the
// merge of runs 2 pair and 2 pair + 1 of `in` (laid out as `ri`), written
// to `out` (laid out as `ro`) or, on the last level, handed to the
// caller's final step one key at a time: fin.emit(row, position, key,
// ctx), ctx = fin.prepare(row, cell) (called by the whole block).
template <class Final>
__global__ void __launch_bounds__(kThreads)
merge_runs_kernel(const uint64_t* __restrict__ in, Runs ri,
                  uint64_t* __restrict__ out, Runs ro, int tiles, bool last,
                  Final fin) {
  __shared__ uint64_t buf[kMergeTile];
  __shared__ int cut[2];
  __shared__ unsigned cell;
  const int tile = blockIdx.x % tiles;
  const int pair = (blockIdx.x / tiles) % ro.count;
  const int row = blockIdx.x / tiles / ro.count;
  const int n_out = ro.length(pair);
  const int d0 = tile * kMergeTile;
  if (d0 >= n_out) return;                       // the whole block
  const int d1 = min(d0 + kMergeTile, n_out);
  const uint64_t* a = in + static_cast<size_t>(row) * ri.row_len()
                      + static_cast<size_t>(2 * pair) * ri.len;
  const uint64_t* b = a + ri.len;
  const int na = ri.length(2 * pair);
  const int nb = 2 * pair + 1 < ri.count ? ri.length(2 * pair + 1) : 0;
  if (threadIdx.x < 2)
    cut[threadIdx.x] = merge_split(a, na, b, nb, threadIdx.x ? d1 : d0);
  __syncthreads();
  const int i0 = cut[0], sa = cut[1] - cut[0];
  const int j0 = d0 - i0, sb = (d1 - d0) - sa;
  for (int t = threadIdx.x; t < sa; t += blockDim.x) buf[t] = a[i0 + t];
  for (int t = threadIdx.x; t < sb; t += blockDim.x) buf[sa + t] = b[j0 + t];
  __syncthreads();
  const int ctx = last ? fin.prepare(row, &cell) : 0;
  const int lo = threadIdx.x * kMergeItems;
  const int hi = min(lo + kMergeItems, d1 - d0);
  if (lo >= hi) return;
  int i = merge_split(buf, sa, buf + sa, sb, lo);
  int j = lo - i;
  uint64_t* dst = out + static_cast<size_t>(row) * ro.row_len()
                  + static_cast<size_t>(pair) * ro.len + d0;
  for (int e = lo; e < hi; ++e) {
    const uint64_t key = (j >= sb || (i < sa && buf[i] > buf[sa + j]))
                             ? buf[i++] : buf[sa + j++];
    if (last) fin.emit(row, d0 + e, key, ctx);
    else dst[e] = key;
  }
}

// The levels after a first level that left each row's chunks' sorted runs
// in `runs` (rows of level_out(N, k, S)), when 2k > S: pairwise merges,
// ping-ponging with `spare` (as large), the last one through `fin`.
template <class Final>
cudaError_t merge_runs(uint64_t* runs, uint64_t* spare, int B, int N, int k,
                       int S, Final fin, cudaStream_t stream) {
  const int chunks = (N + S - 1) / S;
  const int m0 = k < S ? k : S;
  const int tail = N - (chunks - 1) * S;
  Runs r{chunks, m0, k < tail ? k : tail};
  while (r.count > 1) {
    const Runs o = r.merged(k);
    const int tiles = (o.len + kMergeTile - 1) / kMergeTile;
    merge_runs_kernel<Final><<<tiles * o.count * B, kThreads, 0, stream>>>(
        runs, r, spare, o, tiles, o.count == 1, fin);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    uint64_t* t = runs;
    runs = spare;
    spare = t;
    r = o;
  }
  return cudaSuccess;
}

// The top k of rows of n keys already made (`keys`, B x n; reused as
// scratch): a level of chunks of S, then the halving levels (2k <= S) or
// the pairwise merge. `other` holds B * level_out(n, k, S) keys. `fin`
// takes both final forms: a block's sorted survivors (operator()) and one
// key at a time (prepare / emit).
template <class Final>
cudaError_t select_keys(uint64_t* keys, uint64_t* other, int B, int n, int k,
                        int S, Final fin, int device, cudaStream_t stream) {
  if (n <= S || 2 * k <= S)
    return merge_levels(keys, other, B, n, k, S, fin, device, stream);
  static int granted[kMaxDevices];
  const int chunks = (n + S - 1) / S;
  const size_t bytes = smem_bytes(S, pow2_ceil(k < S ? k : S));
  cudaError_t err = allow_smem(keys_level_kernel<Final>, bytes, device,
                               granted);
  if (err != cudaSuccess) return err;
  keys_level_kernel<Final><<<chunks * B, kThreads, bytes, stream>>>(
      keys, n, chunks, other, level_out(n, k, S), k, S, fin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge_runs(other, keys, B, n, k, S, fin, stream);
}

// Runs `body` with `device` current, then restores the caller's device.
template <class Body>
int on_device(int device, Body body) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cur != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t out = body();
  if (cur != device) cudaSetDevice(cur);
  return static_cast<int>(out);
}

}  // namespace sel
