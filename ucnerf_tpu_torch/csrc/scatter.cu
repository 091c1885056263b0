// Deterministic hash-grid table-gradient scatters for Hopper (sm_90a).
//
// K1 (segment_sum_cm)  out[c, r] = sum over m with idx[m] == r of values[c, m]
// K2 (dense_sum_cm)    out[c, base[s] + off_l(k)] += w_k(bf16(frac[:, s])) *
//                      g[c, s] for every sample s of dense level l and every
//                      corner k in 0..7, off_l(k) = bit0(k) + bit1(k) * S_l +
//                      bit2(k) * S_l^2 (S_l the level's corner stride).
// K3 (packed_sum_cm)   K1's sum over updates that were rounded once to bf16
//                      and arrive as pairs in 32-bit words, C / 2 planes:
//                      channel c in the high half of plane c, channel c + C/2
//                      in the low half.
//
// They replace the TPU Pallas kernels ucnerf_tpu/ops/scatter.py::
// scatter_add_cm (K1, pallas_call at scatter.py:221), scatter_add_dense_cm
// (K2, pallas_call at scatter.py:724) and scatter_add_packed_cm (K3,
// pallas_call at scatter.py:473).  Those carry each output tile's sum in VMEM
// over a sequential grid and contract a factored one-hot on the MXU (K3 as a
// single bf16 matmul, its values being bf16 already).  Hopper runs blocks in
// parallel in no order, so the kernels here are GATHER-form reductions with
// no float atomics (scatter_common.cuh): the caller sorts the keys with a
// stable sort (torch.sort, as the JAX package sorts with lax.sort outside its
// kernel) and finds each key's run [starts[k], starts[k+1]) with
// searchsorted; every output row is then owned by exactly one thread group.
//
//   K1: the group of row r walks the run of key r.
//   K2: the group of row r (dense level l) walks the 8 runs of keys
//       r - off_l(k), corner k = 0..7 in that order, and recomputes each
//       sample's corner weight from its fractional coords rounded to bf16
//       (round-to-nearest-even, as scatter.py:619-622 does).  So no 8-fold
//       expansion of the samples is ever stored.
//   K3: K1's walk in K1's order; each update is C / 2 word loads instead of C,
//       widened to f32 in registers and summed in f32.  No f32 [C, M] copy of
//       the updates is ever made.
//
// Bound (bytes, at 3.35 TB/s): per update the permutation entry (8 B) and the
// C value words (K1: 16 B at C = 4; K3: 8 B), or per sample the permutation
// entry, 3 frac words and C grad words (K2: 28 B); per row the run start (4 B)
// and the C output words (16 B).  The random value reads are served at sector
// granularity, so the kernels sit above that bound; K3 reads half the sectors
// of K1.
//
// Offsets are 64-bit: C * M reaches 1.1e8 at the canonical microbatch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scatter_common.cuh"

namespace {

using namespace ucnerf;

constexpr int kMaxLevels = 8;
// What a row's group walks: the run of its own key over f32 planes (K1), the
// 8 corner runs of a dense level (K2), or its own run over bf16 pairs (K3).
enum Mode { kSegment = 0, kDense = 1, kPacked = 2 };

struct DenseLevels {
  int n;
  int64_t offset[kMaxLevels + 1];  // row offsets of the dense levels
  int64_t stride[kMaxLevels];      // corner stride of each level
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Level of dense row r (offset[l] <= r < offset[l + 1]).
__device__ __forceinline__ int dense_level(const DenseLevels& lv, int64_t r) {
  int l = 0;
  while (l + 1 < lv.n && r >= lv.offset[l + 1]) ++l;
  return l;
}

__device__ __forceinline__ int64_t corner_offset(int k, int64_t s) {
  return (k & 1) + ((k >> 1) & 1) * s + ((k >> 2) & 1) * s * s;
}

// ---- K2 ---------------------------------------------------------------

// Adds w_k(frac) * g[:, s] for the samples s of key run [lo, hi) (corner k),
// positions lo + first, lo + first + step, ...
template <int C>
__device__ __forceinline__ void sum_dense_run(
    const float* __restrict__ g, int64_t ldg, const float* __restrict__ fr,
    int64_t ldf, const int64_t* __restrict__ perm, int64_t lo, int64_t hi,
    int k, int first, int step, float (&acc)[C]) {
  for (int64_t p = lo + first; p < hi; p += static_cast<int64_t>(step) *
                                             kUnroll) {
    int64_t col[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + static_cast<int64_t>(u) * step;
      col[u] = q < hi ? load_col(perm + q) : -1;
    }
    float f[kUnroll][3];
    float v[kUnroll][C];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = col[u] >= 0;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        f[u][d] = ok ? __ldg(fr + d * ldf + col[u]) : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[u][c] = ok ? __ldg(g + c * ldg + col[u]) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (col[u] < 0) continue;
      // The TPU kernel's weight: ones, then * f or * (1 - f) per axis.
      float w = 1.0f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float fd = bf16_round(f[u][d]);
        w = w * ((k >> d) & 1 ? fd : 1.0f - fd);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += w * v[u][c];
    }
  }
}

// Length of row r's walk in K2: the 8 corner runs.
__device__ __forceinline__ int64_t dense_walk(const DenseLevels& lv,
                                              const int32_t* __restrict__ starts,
                                              int64_t r) {
  const int l = dense_level(lv, r);
  int64_t n = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t key = r - corner_offset(k, lv.stride[l]);
    if (key >= lv.offset[l]) n += __ldg(starts + key + 1) - __ldg(starts + key);
  }
  return n;
}

// ---- kernels ------------------------------------------------------------

// First pass: a kGroup-lane group per row.  Rows with long walks are listed.
template <int C, Mode kMode>
__global__ void __launch_bounds__(kThreads) rows_kernel(
    const float* __restrict__ values, int64_t ldv,
    const float* __restrict__ fr, int64_t ldf,
    const int64_t* __restrict__ perm, const int32_t* __restrict__ starts,
    DenseLevels lv, int64_t rows, float* __restrict__ out, int64_t ldo,
    int32_t* __restrict__ long_rows, int32_t* __restrict__ long_count) {
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
    if (kMode == kDense) {
      is_long = dense_walk(lv, starts, r) > kLong;
      if (!is_long) {
        const int l = dense_level(lv, r);
#pragma unroll 1
        for (int k = 0; k < 8; ++k) {
          const int64_t key = r - corner_offset(k, lv.stride[l]);
          if (key < lv.offset[l]) continue;
          sum_dense_run<C>(values, ldv, fr, ldf, perm, __ldg(starts + key),
                           __ldg(starts + key + 1), k, sub, kGroup, acc);
        }
      }
    } else {
      const int64_t lo = __ldg(starts + r);
      const int64_t hi = __ldg(starts + r + 1);
      is_long = hi - lo > kLong;
      if (!is_long) {
        sum_run<C, kMode == kPacked>(values, ldv, perm, lo, hi, sub, kGroup,
                                     acc);
      }
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

// Second pass: a block per listed row, blocks striding over the list.
template <int C, Mode kMode>
__global__ void __launch_bounds__(kThreads) long_rows_kernel(
    const float* __restrict__ values, int64_t ldv,
    const float* __restrict__ fr, int64_t ldf,
    const int64_t* __restrict__ perm, const int32_t* __restrict__ starts,
    DenseLevels lv, float* __restrict__ out, int64_t ldo,
    const int32_t* __restrict__ long_rows,
    const int32_t* __restrict__ long_count) {
  __shared__ float red[kThreads / 32 * C];
  const int n = *long_count;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int64_t r = long_rows[i];
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    if (kMode == kDense) {
      const int l = dense_level(lv, r);
#pragma unroll 1
      for (int k = 0; k < 8; ++k) {
        const int64_t key = r - corner_offset(k, lv.stride[l]);
        if (key < lv.offset[l]) continue;
        sum_dense_run<C>(values, ldv, fr, ldf, perm, __ldg(starts + key),
                         __ldg(starts + key + 1), k, threadIdx.x, kThreads,
                         acc);
      }
    } else {
      sum_run<C, kMode == kPacked>(values, ldv, perm, __ldg(starts + r),
                                   __ldg(starts + r + 1), threadIdx.x,
                                   kThreads, acc);
    }
    block_reduce<C>(acc, red);
    if (threadIdx.x == 0) store_row<C>(acc, out, ldo, r);
  }
}

template <int C, Mode kMode>
int launch(const float* values, int64_t ldv, const float* fr, int64_t ldf,
           const int64_t* perm, const int32_t* starts, const DenseLevels& lv,
           int64_t rows, float* out, int64_t ldo, int32_t* long_rows,
           int32_t* long_count, cudaStream_t stream) {
  const int64_t threads = rows * kGroup;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  rows_kernel<C, kMode><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(values, ldv, fr, ldf, perm, starts, lv,
                                    rows, out, ldo, long_rows, long_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  long_rows_kernel<C, kMode><<<kLongBlocks, kThreads, 0, stream>>>(
      values, ldv, fr, ldf, perm, starts, lv, out, ldo, long_rows,
      long_count);
  return static_cast<int>(cudaGetLastError());
}

template <Mode kMode>
int dispatch(int channels, const float* values, int64_t ldv, const float* fr,
             int64_t ldf, const int64_t* perm, const int32_t* starts,
             const DenseLevels& lv, int64_t rows, float* out, int64_t ldo,
             int32_t* long_rows, int32_t* long_count, cudaStream_t stream) {
#define UCNERF_CASE(C)                                                      \
  case C:                                                                   \
    return launch<C, kMode>(values, ldv, fr, ldf, perm, starts, lv, rows,   \
                            out, ldo, long_rows, long_count, stream);
  // Bf16 pairs need an even channel count.
  if (kMode == kPacked && channels % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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

}  // namespace

// K1.  values: C planes of M floats, plane c at values + c * ldv.
// perm: int64 [M], sorted position -> column.  starts: int32 [rows + 1], the
// run of row r is sorted positions [starts[r], starts[r + 1]).  out: C planes
// of `rows` floats at out + c * ldo; every row is written.  long_rows: int32
// scratch of at least min(rows, M / 257 + 1) entries; long_count: one int32,
// zeroed by the caller.  Returns cudaGetLastError() after the launches.
extern "C" int ucnerf_segment_sum_cm(const void* values, long long ldv,
                                     const void* perm, const void* starts,
                                     long long rows, void* out, long long ldo,
                                     int channels, void* long_rows,
                                     void* long_count, void* stream) {
  if (rows <= 0) return 0;
  DenseLevels lv{};
  return dispatch<kSegment>(
      channels, static_cast<const float*>(values), ldv, nullptr, 0,
      static_cast<const int64_t*>(perm), static_cast<const int32_t*>(starts),
      lv, rows, static_cast<float*>(out), ldo,
      static_cast<int32_t*>(long_rows), static_cast<int32_t*>(long_count),
      static_cast<cudaStream_t>(stream));
}

// K2.  g: C planes of M floats (ldg); fr: 3 planes of M floats (ldf), the
// fractional coords (rounded to bf16 here).  perm/starts: the base keys'
// sorted order and runs over [0, rows].  level_offsets (host, nlevels + 1
// entries, the last == rows) and strides (host, nlevels entries) describe the
// dense levels; every sample of level l has its 8 corners inside
// [offset[l], offset[l + 1]).  long_rows: at least min(rows, 8 * M / 257 + 1)
// entries.  Other arguments as for K1.
extern "C" int ucnerf_dense_sum_cm(const void* g, long long ldg,
                                   const void* fr, long long ldf,
                                   const void* perm, const void* starts,
                                   long long rows,
                                   const long long* level_offsets,
                                   const long long* strides, int nlevels,
                                   void* out, long long ldo, int channels,
                                   void* long_rows, void* long_count,
                                   void* stream) {
  if (rows <= 0) return 0;
  if (nlevels < 1 || nlevels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DenseLevels lv{};
  lv.n = nlevels;
  for (int l = 0; l < nlevels; ++l) {
    lv.offset[l] = level_offsets[l];
    lv.stride[l] = strides[l];
  }
  lv.offset[nlevels] = level_offsets[nlevels];
  return dispatch<kDense>(
      channels, static_cast<const float*>(g), ldg,
      static_cast<const float*>(fr), ldf, static_cast<const int64_t*>(perm),
      static_cast<const int32_t*>(starts), lv, rows, static_cast<float*>(out),
      ldo, static_cast<int32_t*>(long_rows),
      static_cast<int32_t*>(long_count), static_cast<cudaStream_t>(stream));
}

// K3.  packed: channels / 2 planes of M 32-bit words (bf16 pairs, see above),
// plane c at packed + c * ldp words.  channels (even) counts the f32 output
// planes.  Other arguments as for K1.
extern "C" int ucnerf_packed_sum_cm(const void* packed, long long ldp,
                                    const void* perm, const void* starts,
                                    long long rows, void* out, long long ldo,
                                    int channels, void* long_rows,
                                    void* long_count, void* stream) {
  if (rows <= 0) return 0;
  DenseLevels lv{};
  return dispatch<kPacked>(
      channels, static_cast<const float*>(packed), ldp, nullptr, 0,
      static_cast<const int64_t*>(perm), static_cast<const int32_t*>(starts),
      lv, rows, static_cast<float*>(out), ldo,
      static_cast<int32_t*>(long_rows), static_cast<int32_t*>(long_count),
      static_cast<cudaStream_t>(stream));
}
