// Shared pieces of the deterministic table-gradient scatters (scatter.cu,
// scatter_chunked.cu): the block geometry, the walk over one sorted run, the
// sources of update values, and the fixed-order reductions.
//
// Every kernel built from these is a GATHER-form reduction with no float
// atomics: the caller sorts the keys with a stable sort, every run of equal
// keys has exactly one owner, which sums it in a fixed order, and every output
// row is written once, 0 where no update lands.  The result is bitwise the
// same on every launch.
//
// scatter.cu gives each output row one thread, one warp or one block by the
// length of its walk (see the note there); scatter_chunked.cu gives each run
// to the thread on its first key and runs longer than kLong to its whole
// block.  Warps and blocks combine their lanes with fixed xor-shuffle and
// block trees.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ucnerf {

constexpr int kUnroll = 4;    // loads in flight per thread (scatter_chunked)
constexpr int kLong = 256;    // scatter_chunked: longer runs go to the block
constexpr int kThreads = 256;
// Blocks of a second pass: 132 SMs, a few blocks each; idle blocks exit after
// reading the count.
constexpr int kLongBlocks = 132 * 4;

// Read-only 64-bit load (__ldg is declared for long long, not int64_t).
__device__ __forceinline__ int64_t load_col(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

// C contiguous floats, in 16- or 8-byte loads where C allows (p aligned to
// 4 * C bytes, up to 16).
template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p) + i);
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(p + c);
  }
}

// Sources of the update at a column: load(col, v) fills v[C].

// C planes of f32, plane c at values + c * ld (K1, K5).
template <int C>
struct F32Planes {
  const float* __restrict__ values;
  int64_t ld;
  __device__ __forceinline__ void load(int64_t col, float (&v)[C]) const {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(values + c * ld + col);
  }
};

// C / 2 planes of 32-bit words (stride ld), each word a pair of bf16 values:
// channel c in the high half of plane c's word, channel c + C / 2 in its low
// half (K3).  The halves are widened to f32 in registers (a bf16 is the high
// half of an f32).  The words are handled as uint32_t: a left shift of a
// negative int is undefined.
template <int C>
struct Bf16Pairs {
  const uint32_t* __restrict__ words;
  int64_t ld;
  __device__ __forceinline__ void load(int64_t col, float (&v)[C]) const {
#pragma unroll
    for (int c = 0; c < C / 2; ++c) {
      const uint32_t bits = __ldg(words + c * ld + col);
      v[c] = __uint_as_float(bits & 0xFFFF0000u);
      v[c + C / 2] = __uint_as_float(bits << 16);
    }
  }
};

// Adds src(perm[p]) for p = lo + first, lo + first + step, ... < hi, kU
// loads in flight.
template <int C, int kU, class Src>
__device__ __forceinline__ void sum_run(const Src& src,
                                        const int64_t* __restrict__ perm,
                                        int64_t lo, int64_t hi, int first,
                                        int step, float (&acc)[C]) {
  for (int64_t p = lo + first; p < hi; p += static_cast<int64_t>(step) * kU) {
    int64_t col[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t q = p + static_cast<int64_t>(u) * step;
      col[u] = q < hi ? load_col(perm + q) : -1;
    }
    float v[kU][C];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (col[u] >= 0) {
        src.load(col[u], v[u]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) v[u][c] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (col[u] >= 0) acc[c] += v[u][c];
      }
    }
  }
}

// Fixed xor-shuffle tree over the 32 lanes of a warp; every lane ends with
// the same total.
template <int C>
__device__ __forceinline__ void warp_reduce(float (&acc)[C]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
  }
}

// Fixed block tree: xor-shuffle in each warp, then warp sums in warp order.
// Returns the total in thread 0.  `red` holds kThreads / 32 * C floats.
template <int C>
__device__ __forceinline__ void block_reduce(float (&acc)[C], float* red) {
  warp_reduce<C>(acc);
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
