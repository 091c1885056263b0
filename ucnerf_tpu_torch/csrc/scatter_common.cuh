// Shared pieces of the deterministic table-gradient scatters (scatter.cu,
// scatter_chunked.cu): the lane-group and block geometry, the walk over one
// sorted run, and the fixed-order reductions.
//
// Every kernel built from these is a GATHER-form reduction with no float
// atomics: the caller sorts the keys with a stable sort, every run of equal
// keys has exactly one owner, which sums it in a fixed order, and every output
// row is written once, 0 where no update lands.  The result is bitwise the
// same on every launch.
//
// scatter.cu gives each output row a G-lane group: lane j sums positions j,
// j+G, ... of each run in turn, then the G lanes combine with a fixed
// xor-shuffle tree.  Rows whose walk is longer than kLong elements (a coarse
// level's skew: one cell can take 1e5 samples) are not walked by a 4-lane
// group: the group appends the row to a list (integer atomic; the list's
// order does not matter), and a second kernel gives each listed row a whole
// 256-thread block with a fixed block-tree reduction.  Each row's sum is the
// same whichever block takes it.  scatter_chunked.cu gives each run to the
// thread on its first key and runs longer than kLong to its whole block, with
// the same block tree.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ucnerf {

constexpr int kGroup = 4;     // lanes per output row in the first pass
constexpr int kUnroll = 4;    // loads in flight per lane
constexpr int kLong = 256;    // longer walks go to the block-per-row pass
constexpr int kThreads = 256;
// Blocks of a second pass: 132 SMs, a few blocks each; idle blocks exit after
// reading the count.
constexpr int kLongBlocks = 132 * 4;

// Read-only 64-bit load (__ldg is declared for long long, not int64_t).
__device__ __forceinline__ int64_t load_col(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

// Adds values[:, perm[p]] for p = lo + first, lo + first + step, ... < hi.
//
// kPacked = false: `values` holds C planes of f32, plane c at values + c * ldv.
// kPacked = true: it holds C / 2 planes of 32-bit words (same stride), each
// word a pair of bf16 values: channel c in the high half of plane c's word,
// channel c + C / 2 in its low half.  The halves are widened to f32 in
// registers (a bf16 is the high half of an f32) and summed in f32.  The words
// are handled as uint32_t: a left shift of a negative int is undefined.
template <int C, bool kPacked>
__device__ __forceinline__ void sum_run(const float* __restrict__ values,
                                        int64_t ldv,
                                        const int64_t* __restrict__ perm,
                                        int64_t lo, int64_t hi, int first,
                                        int step, float (&acc)[C]) {
  for (int64_t p = lo + first; p < hi; p += static_cast<int64_t>(step) *
                                             kUnroll) {
    int64_t col[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + static_cast<int64_t>(u) * step;
      col[u] = q < hi ? load_col(perm + q) : -1;
    }
    float v[kUnroll][C];
    if constexpr (kPacked) {
      const uint32_t* words = reinterpret_cast<const uint32_t*>(values);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < C / 2; ++c) {
          const uint32_t bits =
              col[u] >= 0 ? __ldg(words + c * ldv + col[u]) : 0u;
          v[u][c] = __uint_as_float(bits & 0xFFFF0000u);
          v[u][c + C / 2] = __uint_as_float(bits << 16);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          v[u][c] = col[u] >= 0 ? __ldg(values + c * ldv + col[u]) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (col[u] >= 0) acc[c] += v[u][c];
      }
    }
  }
}

template <int C>
__device__ __forceinline__ void group_reduce(float (&acc)[C]) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off, kGroup);
    }
  }
}

// Fixed block tree: xor-shuffle in each warp, then warp sums in warp order.
// Returns the total in thread 0.  `red` holds kThreads / 32 * C floats.
template <int C>
__device__ __forceinline__ void block_reduce(float (&acc)[C], float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) red[warp * C + c] = acc[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float s = red[c];
      for (int w = 1; w < kThreads / 32; ++w) s += red[w * C + c];
      acc[c] = s;
    }
  }
  __syncthreads();
}

template <int C>
__device__ __forceinline__ void store_row(const float (&acc)[C], float* out,
                                          int64_t ldo, int64_t r) {
#pragma unroll
  for (int c = 0; c < C; ++c) out[c * ldo + r] = acc[c];
}

}  // namespace ucnerf
