// Deterministic scatter-add over chunk-local sorts for Hopper (sm_90a).
//
// K5 (chunked_sum_cm)  out[c, r] = sum over m with idx[m] == r of values[c, m]
//                      where the stream of M updates is cut into G equal
//                      chunks, each sorted on its own.
//
// It replaces the TPU Pallas kernel ucnerf_tpu/ops/scatter.py::
// scatter_add_chunked_cm (pallas_call at scatter.py:899), whose (tile, chunk)
// grid keeps an output tile in VMEM while the chunks' contributions arrive in
// chunk order, with a [tiles, G] table of block ranges prefetched as scalars.
// Here the caller sorts the [G, M / G] view of the keys with one batched stable
// torch.sort, and every output row is owned by one thread group
// (scatter_common.cuh) that visits chunk 0, 1, ..., G - 1 in that order and
// walks the row's run inside each chunk in sorted order: a fixed summation
// order, no float atomics, bitwise the same on every launch.
//
// Where a row's run lies inside a chunk is found by the group itself, with a
// binary search of the chunk's sorted keys for the run's start and a galloping
// search for its end (most runs hold 0 or 1 updates).  The alternative, a
// dense [G, rows + 1] table of run starts made by the caller, costs G * rows
// * 4 B of device memory (1.4 GB at G = 24 and 14.68 M rows) and the same
// G * rows searches to fill it.
//
// Bound (bytes, at 3.35 TB/s): per update the key (4 B), the permutation entry
// (8 B) and C value words; per row C output words.  The searches read each key
// many times over (G * rows * log2(M / G) probes, mostly from L2), so the
// kernel is bound by those probes, not by the bytes.

#include <cstdint>

#include <cuda_runtime.h>

#include "scatter_common.cuh"

namespace {

using namespace ucnerf;

// First position in sorted keys[lo, hi) whose key is >= key.
__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ keys,
                                               int64_t lo, int64_t hi,
                                               int64_t key) {
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (__ldg(keys + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// End of the run of `key` that starts at lo = lower_bound(key) in keys[, end):
// doubling steps while the key holds, then a binary search of the last step.
__device__ __forceinline__ int64_t run_end(const int32_t* __restrict__ keys,
                                           int64_t lo, int64_t end,
                                           int64_t key) {
  if (lo >= end || __ldg(keys + lo) != key) return lo;
  int64_t last = lo;  // keys[last] == key
  int64_t step = 1;
  while (last + step < end && __ldg(keys + last + step) == key) {
    last += step;
    step <<= 1;
  }
  const int64_t stop = last + step < end ? last + step : end;
  return lower_bound(keys, last + 1, stop, key + 1);
}

// The run of row r in chunk g: sorted positions [lo, hi) of the whole stream.
__device__ __forceinline__ void chunk_run(const int32_t* __restrict__ keys,
                                          int64_t chunk_len, int g, int64_t r,
                                          int64_t* lo, int64_t* hi) {
  const int64_t base = static_cast<int64_t>(g) * chunk_len;
  *lo = lower_bound(keys, base, base + chunk_len, r);
  *hi = run_end(keys, *lo, base + chunk_len, r);
}

// First pass: a kGroup-lane group per row walks the chunks in order.  A row
// whose updates over all chunks pass kLong is listed for the second pass (the
// group stops where the count passes kLong; what it summed is dropped).
template <int C>
__global__ void __launch_bounds__(kThreads) chunk_rows_kernel(
    const float* __restrict__ values, int64_t ldv,
    const int32_t* __restrict__ keys, const int64_t* __restrict__ perm,
    int chunks, int64_t chunk_len, int64_t rows, float* __restrict__ out,
    int64_t ldo, int32_t* __restrict__ long_rows,
    int32_t* __restrict__ long_count) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t r = tid / kGroup;
  const int sub = static_cast<int>(tid % kGroup);
  const bool valid = r < rows;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  bool is_long = false;
  if (valid) {
    int64_t count = 0;
    for (int g = 0; g < chunks; ++g) {
      int64_t lo, hi;
      chunk_run(keys, chunk_len, g, r, &lo, &hi);
      count += hi - lo;
      if (count > kLong) {
        is_long = true;
        break;
      }
      // perm holds columns inside the chunk.
      const int64_t base = static_cast<int64_t>(g) * chunk_len;
      sum_run<C, false>(values + base, ldv, perm, lo, hi, sub, kGroup, acc);
    }
  }
  group_reduce<C>(acc);  // every lane of the warp takes part
  if (valid && sub == 0) {
    if (is_long) {
      long_rows[atomicAdd(long_count, 1)] = static_cast<int32_t>(r);
    } else {
      store_row<C>(acc, out, ldo, r);
    }
  }
}

// Second pass: a block per listed row, chunk by chunk.
template <int C>
__global__ void __launch_bounds__(kThreads) chunk_long_rows_kernel(
    const float* __restrict__ values, int64_t ldv,
    const int32_t* __restrict__ keys, const int64_t* __restrict__ perm,
    int chunks, int64_t chunk_len, float* __restrict__ out, int64_t ldo,
    const int32_t* __restrict__ long_rows,
    const int32_t* __restrict__ long_count) {
  __shared__ float red[kThreads / 32 * C];
  const int n = *long_count;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int64_t r = long_rows[i];
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    for (int g = 0; g < chunks; ++g) {
      int64_t lo, hi;
      chunk_run(keys, chunk_len, g, r, &lo, &hi);
      const int64_t base = static_cast<int64_t>(g) * chunk_len;
      sum_run<C, false>(values + base, ldv, perm, lo, hi, threadIdx.x,
                        kThreads, acc);
    }
    block_reduce<C>(acc, red);
    if (threadIdx.x == 0) store_row<C>(acc, out, ldo, r);
  }
}

template <int C>
int launch(const float* values, int64_t ldv, const int32_t* keys,
           const int64_t* perm, int chunks, int64_t chunk_len, int64_t rows,
           float* out, int64_t ldo, int32_t* long_rows, int32_t* long_count,
           cudaStream_t stream) {
  const int64_t threads = rows * kGroup;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  chunk_rows_kernel<C><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(values, ldv, keys, perm, chunks, chunk_len,
                                   rows, out, ldo, long_rows, long_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_long_rows_kernel<C><<<kLongBlocks, kThreads, 0, stream>>>(
      values, ldv, keys, perm, chunks, chunk_len, out, ldo, long_rows,
      long_count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5.  values: C planes of M = chunks * chunk_len floats, plane c at values +
// c * ldv.  keys: int32 [chunks * chunk_len], each chunk sorted ascending.
// perm: int64 [chunks * chunk_len], sorted position -> column inside its
// chunk (what a batched torch.sort over the [chunks, chunk_len] view
// returns).  out: C planes of `rows` floats at out + c * ldo; every row is
// written.  long_rows: int32 scratch of at least min(rows, M / 257 + 1)
// entries; long_count: one int32, zeroed by the caller.  Returns
// cudaGetLastError() after the launches.
extern "C" int ucnerf_chunked_sum_cm(const void* values, long long ldv,
                                     const void* keys, const void* perm,
                                     int chunks, long long chunk_len,
                                     long long rows, void* out, long long ldo,
                                     int channels, void* long_rows,
                                     void* long_count, void* stream) {
  if (rows <= 0) return 0;
  if (chunks < 1 || chunk_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define UCNERF_CASE(C)                                                       \
  case C:                                                                    \
    return launch<C>(static_cast<const float*>(values), ldv,                 \
                     static_cast<const int32_t*>(keys),                      \
                     static_cast<const int64_t*>(perm), chunks, chunk_len,   \
                     rows, static_cast<float*>(out), ldo,                    \
                     static_cast<int32_t*>(long_rows),                       \
                     static_cast<int32_t*>(long_count),                      \
                     static_cast<cudaStream_t>(stream));
  switch (channels) {
    UCNERF_CASE(1)
    UCNERF_CASE(2)
    UCNERF_CASE(3)
    UCNERF_CASE(4)
    UCNERF_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef UCNERF_CASE
}
