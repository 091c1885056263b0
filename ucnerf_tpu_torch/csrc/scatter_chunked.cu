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
// torch.sort, and the kernel walks the KEYS, not the rows:
//
//  * One block owns a tile of kTile consecutive output rows and keeps their
//    sums in shared memory (C * kTile floats, zeroed once).
//  * Where the tile's keys lie inside each chunk is found first, for a batch
//    of chunks at once: one thread per (chunk, tile edge) runs one binary
//    search, so the searches of a batch overlap.  That is G * rows / kTile
//    search pairs in all, where a search per (row, chunk) costs G * rows.
//  * Then, chunk by chunk in chunk order, the block reads the tile's range of
//    that chunk's sorted keys (neighbouring threads, neighbouring keys; every
//    key is read by one block).  The thread that sits on the first key of a
//    run owns that row for this chunk (a row has at most one run per chunk):
//    it sums the run's values through the permutation, in sorted order, and
//    adds the sum to the row in shared memory.  A __syncthreads() between
//    chunks keeps the chunk order.
//  * A run longer than kLong (a coarse level's skew: one cell can take 1e5
//    samples) is not walked by one thread: its start goes to a list in shared
//    memory, and after the chunk's short runs the whole block sums each listed
//    run with the fixed block tree (scatter_common.cuh).  Which runs are
//    listed depends on the data alone, and each belongs to another row, so
//    the list's order does not matter.
//  * After the last chunk the tile is stored, every row written, 0 where no
//    update landed.
//
// The order of every sum is fixed by the data: no float atomics, bitwise the
// same on every launch.
//
// Bound (bytes, at 3.35 TB/s): per update the key (4 B), the permutation entry
// (8 B) and C value words; per row C output words.  What the kernel pays above
// that is the same as K1 on the same stream, and it takes K1's time: the
// value words are read through the permutation, 4-byte words scattered over a
// chunk's columns, so each costs a 32-byte sector of DRAM.  (A chunk's values
// would fit L2, 10.8 MB a chunk of the NeRF stream at G = 24, but the blocks
// in flight are spread over all chunks, so nothing stays there.)  A variant
// that found the ranges in a kernel of its own and took the chunks' ranges as
// one list, four positions a thread, was no faster on the card.

#include <cstdint>

#include <cuda_runtime.h>

#include "scatter_common.cuh"

namespace {

using namespace ucnerf;

constexpr int kTile = 1024;           // output rows per block
constexpr int kBatch = kThreads / 2;  // chunks whose tile ranges are found at once

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

template <int C>
__global__ void __launch_bounds__(kThreads) chunk_tiles_kernel(
    const float* __restrict__ values, int64_t ldv,
    const int32_t* __restrict__ keys, const int64_t* __restrict__ perm,
    int chunks, int64_t chunk_len, int64_t rows, float* __restrict__ out,
    int64_t ldo) {
  __shared__ float tile[C * kTile];
  __shared__ float red[kThreads / 32 * C];
  __shared__ int64_t edges[2 * kBatch];  // [2 b], [2 b + 1]: chunk b's range
  __shared__ int64_t long_runs[kTile];   // starts of the runs left to the block
  __shared__ int long_count;

  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t row1 = row0 + kTile < rows ? row0 + kTile : rows;
  for (int i = tid; i < C * kTile; i += kThreads) tile[i] = 0.0f;
  if (tid == 0) long_count = 0;

  for (int g0 = 0; g0 < chunks; g0 += kBatch) {
    const int batch = chunks - g0 < kBatch ? chunks - g0 : kBatch;
    __syncthreads();  // the last batch's edges are no longer read
    if (tid < 2 * batch) {
      const int64_t base = static_cast<int64_t>(g0 + tid / 2) * chunk_len;
      edges[tid] = lower_bound(keys, base, base + chunk_len,
                               tid % 2 ? row1 : row0);
    }
    __syncthreads();

    for (int b = 0; b < batch; ++b) {
      const int64_t lo = edges[2 * b], hi = edges[2 * b + 1];
      // perm holds columns inside the chunk.
      const float* chunk_values =
          values + static_cast<int64_t>(g0 + b) * chunk_len;
      for (int64_t p = lo + tid; p < hi; p += kThreads) {
        const int32_t key = __ldg(keys + p);
        if (p > lo && __ldg(keys + p - 1) == key) continue;  // not a run's head
        int64_t end = p + 1;
        while (end < hi && end - p <= kLong && __ldg(keys + end) == key) ++end;
        if (end - p > kLong) {
          long_runs[atomicAdd(&long_count, 1)] = p;
          continue;
        }
        float acc[C];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = 0.0f;
        sum_run<C, kUnroll>(F32Planes<C>{chunk_values, ldv}, perm, p, end, 0, 1,
                               acc);
        const int local = static_cast<int>(key - row0);
#pragma unroll
        for (int c = 0; c < C; ++c) tile[c * kTile + local] += acc[c];
      }
      __syncthreads();  // the short runs are added and the list is complete
      const int listed = long_count;
      for (int i = 0; i < listed; ++i) {
        const int64_t p = long_runs[i];
        const int32_t key = __ldg(keys + p);
        const int64_t end = lower_bound(keys, p, hi,
                                        static_cast<int64_t>(key) + 1);
        float acc[C];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = 0.0f;
        sum_run<C, kUnroll>(F32Planes<C>{chunk_values, ldv}, perm, p, end, tid,
                               kThreads, acc);
        block_reduce<C>(acc, red);
        if (tid == 0) {
          const int local = static_cast<int>(key - row0);
#pragma unroll
          for (int c = 0; c < C; ++c) tile[c * kTile + local] += acc[c];
        }
      }
      // Before the next chunk appends to the list and adds to the tile, every
      // thread has read this chunk's count and thread 0 has added its sums.
      __syncthreads();
      if (tid == 0) long_count = 0;
      __syncthreads();
    }
  }

  const int width = static_cast<int>(row1 - row0);
  for (int i = tid; i < width; i += kThreads) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[c * ldo + row0 + i] = tile[c * kTile + i];
  }
}

template <int C>
int launch(const float* values, int64_t ldv, const int32_t* keys,
           const int64_t* perm, int chunks, int64_t chunk_len, int64_t rows,
           float* out, int64_t ldo, cudaStream_t stream) {
  const int64_t blocks = (rows + kTile - 1) / kTile;
  chunk_tiles_kernel<C><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(values, ldv, keys, perm, chunks, chunk_len,
                                    rows, out, ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5.  values: C planes of M = chunks * chunk_len floats, plane c at values +
// c * ldv.  keys: int32 [chunks * chunk_len], each chunk sorted ascending;
// keys outside [0, rows) are skipped.  perm: int64 [chunks * chunk_len],
// sorted position -> column inside its chunk (what a batched torch.sort over
// the [chunks, chunk_len] view returns).  out: C planes of `rows` floats at
// out + c * ldo; every row is written.  Returns cudaGetLastError() after the
// launch.
extern "C" int ucnerf_chunked_sum_cm(const void* values, long long ldv,
                                     const void* keys, const void* perm,
                                     int chunks, long long chunk_len,
                                     long long rows, void* out, long long ldo,
                                     int channels, void* stream) {
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
