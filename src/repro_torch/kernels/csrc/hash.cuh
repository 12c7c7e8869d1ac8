// The uint32 hashes of core/hashing.py in native uint32 arithmetic, shared
// by buckets.cu and sketch.cu: the murmur3 finalizer and the seeded
// universal hash. Every product and sum wraps mod 2^32 as the reference's
// uint32 lanes do, so the results are bitwise core/hashing.py's.
#pragma once

#include <cstdint>

namespace hashing {

constexpr uint32_t kGolden = 0x9E3779B9u;

// murmur3 finalizer: a full-avalanche 32-bit mix (hashing.fmix32).
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// hashing.uhash(seed, x) with `seed_mix` = fmix32(seed), a constant the
// host computes once a call.
__device__ __forceinline__ uint32_t uhash(uint32_t x, uint32_t seed_mix) {
  return fmix32(x * kGolden ^ seed_mix);
}

}  // namespace hashing
