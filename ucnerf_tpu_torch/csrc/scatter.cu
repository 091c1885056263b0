// Deterministic hash-grid table-gradient scatters for Hopper (sm_90a).
//
// K1 (segment_sum_cm)  out[c, r] = sum over m with idx[m] == r of values[c, m]
// K1, fused entry      the same sum with values[c, m] = w[m] * g[l, c, s]
//   (wsum_sum_cm)      formed in the kernel, m = (l * 8 + k) * N + s (level,
//                      corner, sample), so the [C, 8 N L] values never exist.
// K2 (dense_sum_cm)    out[c, base[s] + off_l(k)] += w_k(bf16(frac[:, s])) *
//                      g[c, s] for every sample s of dense level l and every
//                      corner k in 0..7, off_l(k) = bit0(k) + bit1(k) * S_l +
//                      bit2(k) * S_l^2 (S_l the level's corner stride).
// K3 (packed_sum_cm)   K1's sum over updates that were rounded once to bf16
//                      and arrive as pairs in 32-bit words, C / 2 planes:
//                      channel c in the high half of plane c, channel c + C/2
//                      in the low half.
// K3, fused entry      K3's sum over the fused K1 entry's updates: each
//   (wsum_packed_sum_  w[m] * g[l, c, s] formed with f32 rounding and rounded
//    cm)               once to bf16 in the kernel, so neither the [C, 8 N L]
//                      values nor the [C / 2, M] planes exist.
// Run starts           starts[r] = the first sorted position whose key is >= r
//   (run_starts)       (torch.searchsorted of 0..rows in the sorted keys).
//
// They replace the TPU Pallas kernels ucnerf_tpu/ops/scatter.py::
// scatter_add_cm (K1, pallas_call at scatter.py:221), scatter_add_dense_cm
// (K2, pallas_call at scatter.py:724) and scatter_add_packed_cm (K3,
// pallas_call at scatter.py:473).  Those carry each output tile's sum in VMEM
// over a sequential grid and contract a factored one-hot on the MXU.  Hopper
// runs blocks in parallel in no order, so the kernels here are GATHER-form
// reductions with no float atomics (scatter_common.cuh): the caller sorts the
// keys with a stable sort (torch.sort, as the JAX package sorts with lax.sort
// outside its kernel), run_starts finds each key's run [starts[k],
// starts[k + 1]) in one pass over the sorted keys, and every output row is
// then owned by exactly one thread, warp or block.
//
// Tiers.  The first pass gives every row one thread, which finds the length
// of the row's walk: up to Walk::kThreadWalk it walks the row itself; longer
// rows are appended to a warp list or, past Walk::kWarpWalk, a block list
// (warp-aggregated integer atomics; the lists' order does not matter), and a
// second pass gives each listed row a warp or a 256-thread block with a fixed
// shuffle / block tree.  A row's tier, and so its order of summation, follows
// from the data alone.  The limits and loads in flight follow the walk
// lengths of the canonical microbatch.  A hashed row takes ~4.4 updates
// (proposal grid, 99.9th percentile 12) or ~1.1 (NeRF grid, 5) on a uniform
// stream: one thread per row with 8 loads in flight (the fused entry 4 where
// the mean walk is under 2), where a group of lanes would each hold about one
// update and wait on latency.  A dense row of level 2, 1 or 0 walks ~35, ~280
// or ~2250 samples: thread, warp, block.  A coarse level's skew (one cell can
// take 1e5 samples) goes to a block.
//
//   K1: a row walks the run of its key.  The plain entry reads C words from C
//       planes per update; the fused entry first interleaves the [L, C, N]
//       feature grads into a [L, N, C] scratch (one streaming pass) and then
//       reads per update the weight word w[m] and one 16-byte row, and
//       multiplies with __fmul_rn, torch's rounding.  Both walk in one order,
//       so the fused entry is bitwise K1 on the torch-formed w * g.
//   K2: each dense sample's C grads and 3 fracs (rounded to bf16 once, as
//       the Pallas kernel does at scatter.py:619-622) are packed into a
//       32-byte record (pass A, sample order) and the records are copied to
//       their sorted positions (pass B, one random 32-byte read each).
//       Corners k and k ^ 1 of row r have the adjacent keys r - off_l(k & 6)
//       - 1 and r - off_l(k & 6), so a row's 8 corner runs are 4 contiguous
//       slices of the sorted records; a record's corner follows from which
//       side of its slice's split it lies on, and its weight from its fracs
//       (ones, then * f or * (1 - f) per axis, the TPU kernel's order).  Each
//       record is read 8 times, from contiguous slices.
//   K3: K1's walk in K1's order; each update is C / 2 word loads instead of C,
//       widened to f32 in registers and summed in f32.
//   K3, fused entry: with the bf16 rounding the C values of an update fit
//       one record of C / 2 words (8 bytes at C = 4: channel 2j in the low
//       half of word j, 2j + 1 in the high half).  One pass reads the grads
//       and weights once, in sample order, and writes each update's record
//       at its column, (l * 8 + k) * N + s (coalesced).  The walk, K1's
//       (same tiers, same order), reads each record through the
//       permutation: one random sector an update, against the planar K3's
//       C / 2 and the fused K1 entry's 2.  The result is bitwise K3 on the
//       torch-formed, rounded updates.  A second pass that copied the
//       records to their sorted positions first, so that the walk read
//       contiguous runs, was no faster on the H100 at either grid: its
//       random read costs what the walk's does.
//
// Bound (bytes, at 3.35 TB/s): per update the permutation entry (8 B) and its
// value words (K1: 16 B at C = 4; fused: 4 B of weight, and the [L, C, N]
// grads once; K3: 8 B), per dense sample the permutation entry, 3 frac words
// and C grad words (K2: 28 B); per row the run start (4 B) and the C output
// words.  The random reads are served a 32-byte sector at a time, so K1 and
// K3 sit above that bound: K1's plain entry reads C sectors an update, the
// fused entry 2, K3 C / 2, K3's fused entry 1.  K2 reads one random sector per
// sample.  K3's fused entry has K1's fused bound; its records add a round
// trip of 2 C bytes an update.
//
// Offsets are 64-bit: C * M reaches 1.1e8 at the canonical microbatch.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scatter_common.cuh"

namespace {

using namespace ucnerf;

constexpr int kMaxLevels = 8;
constexpr int kRowUnroll = 8;  // loads in flight per thread of a walk
constexpr int kGapInline = 32;  // run_starts: longer gaps are filled by a warp

struct DenseLevels {
  int n;
  int64_t offset[kMaxLevels + 1];  // row offsets of the dense levels
  int64_t stride[kMaxLevels];      // corner stride of each level
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The bits of x rounded to bf16 (round to nearest even), in the low half.
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
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

template <int C>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = v[c];
  }
}

// ---- walks: what a row's owner sums ------------------------------------

// The fused entry's update at column col = (l * 8 + k) * n + s: w[col] (w is
// [L, 8, n]) times row l * n + s of the [L n, C] interleaved grads.
template <int C>
struct WeightedRows {
  const float* __restrict__ w;
  const float* __restrict__ rows;
  int64_t n;
  __device__ __forceinline__ void load(int64_t col, float (&v)[C]) const {
    // l * 8 + k, in 32 bits: the run starts are int32, so col < 2^31.
    const int64_t q = static_cast<uint32_t>(col) / static_cast<uint32_t>(n);
    const int64_t s = col - q * n;
    const float wk = __ldg(w + col);
    float g[C];
    load_row<C>(rows + ((q >> 3) * n + s) * C, g);
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __fmul_rn(wk, g[c]);
  }
};

// K3's fused entry's update at column col: the record of C / 2 words at
// rec + col * C / 2, word j a pair of bf16 values, channel 2j in its low half
// and 2j + 1 in its high half.  The words are moved as floats (a load or a
// store keeps every bit) and split as uint32_t, as in Bf16Pairs.
template <int C>
struct Bf16Records {
  const float* __restrict__ rec;
  __device__ __forceinline__ void load(int64_t col, float (&v)[C]) const {
    float words[C / 2];
    load_row<C / 2>(rec + col * (C / 2), words);
#pragma unroll
    for (int j = 0; j < C / 2; ++j) {
      const uint32_t bits = __float_as_uint(words[j]);
      v[2 * j] = __uint_as_float(bits << 16);
      v[2 * j + 1] = __uint_as_float(bits & 0xFFFF0000u);
    }
  }
};

// K1, its fused entry, K3 and its fused entry: the run of the row's own key.
// kU loads in flight per thread; the order of the sum does not depend on it.
template <int C, class Src, int kU>
struct RunWalk {
  static constexpr int kC = C;
  static constexpr int kThreadWalk = 32;
  static constexpr int kWarpWalk = 1024;
  Src src;
  const int64_t* __restrict__ perm;
  const int32_t* __restrict__ starts;

  __device__ __forceinline__ int64_t length(int64_t r) const {
    return __ldg(starts + r + 1) - __ldg(starts + r);
  }
  __device__ __forceinline__ void sum(int64_t r, int first, int step,
                                      float (&acc)[C]) const {
    sum_run<C, kU>(src, perm, __ldg(starts + r), __ldg(starts + r + 1),
                   first, step, acc);
  }
};

// A dense sample's record: C grads, 3 bf16-rounded fracs, zeros to a
// multiple of 4 floats (32 bytes at C = 4).
template <int C>
__host__ __device__ constexpr int record_floats() {
  return (C + 3 + 3) / 4 * 4;
}

// K2: the 4 slices of sorted records that hold a row's 8 corner runs.
template <int C>
struct DenseWalk {
  static constexpr int kC = C;
  static constexpr int kRec = record_floats<C>();
  static constexpr int kThreadWalk = 64;
  static constexpr int kWarpWalk = 2048;
  const float* __restrict__ rec;  // [M, kRec] in sorted order
  const int32_t* __restrict__ starts;
  DenseLevels lv;

  // Slice j of row r (level offset lo_row, corner stride s): corner 2j + 1
  // at sorted positions [lo, split), corner 2j at [split, hi).
  __device__ __forceinline__ void slice(int64_t r, int64_t lo_row, int64_t s,
                                        int j, int64_t& lo, int64_t& split,
                                        int64_t& hi) const {
    const int64_t key = r - corner_offset(2 * j, s);
    if (key < lo_row) {
      lo = split = hi = 0;
      return;
    }
    split = __ldg(starts + key);
    hi = __ldg(starts + key + 1);
    lo = key - 1 >= lo_row ? __ldg(starts + key - 1) : split;
  }

  __device__ __forceinline__ int64_t length(int64_t r) const {
    const int l = dense_level(lv, r);
    int64_t n = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int64_t lo, split, hi;
      slice(r, lv.offset[l], lv.stride[l], j, lo, split, hi);
      n += hi - lo;
    }
    return n;
  }

  // Lane `first` of `step` takes positions first, first + step, ... of the
  // 4 slices laid end to end.
  __device__ __forceinline__ void sum(int64_t r, int first, int step,
                                      float (&acc)[C]) const {
    const int l = dense_level(lv, r);
    int64_t off = first;
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      int64_t lo, split, hi;
      slice(r, lv.offset[l], lv.stride[l], j, lo, split, hi);
      for (int64_t p = lo + off; p < hi;
           p += static_cast<int64_t>(step) * kRowUnroll) {
        float v[kRowUnroll][kRec];
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) {
          const int64_t q = p + static_cast<int64_t>(u) * step;
          if (q < hi) load_row<kRec>(rec + q * kRec, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kRowUnroll; ++u) {
          const int64_t q = p + static_cast<int64_t>(u) * step;
          if (q >= hi) continue;
          const int k = q < split ? 2 * j + 1 : 2 * j;
          // The TPU kernel's weight: ones, then * f or * (1 - f) per axis.
          float w = 1.0f;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float fd = v[u][C + d];
            w = w * ((k >> d) & 1 ? fd : 1.0f - fd);
          }
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += w * v[u][c];
        }
      }
      const int64_t len = hi - lo;
      off = off >= len ? off - len : (step - (len - off) % step) % step;
    }
  }
};

// ---- tiers --------------------------------------------------------------

// Appends r to list for every lane that wants to: one atomic per warp.  All
// 32 lanes of the warp call it.
__device__ __forceinline__ void append(int32_t* __restrict__ list,
                                       int32_t* __restrict__ count, bool want,
                                       int64_t r) {
  const unsigned mask = __ballot_sync(0xffffffffu, want);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (want) {
    list[base + __popc(mask & ((1u << lane) - 1u))] = static_cast<int32_t>(r);
  }
}

// First pass: a thread per row; short walks are summed here, the others
// listed for the warp (lists[0, warp_cap)) and block (lists[warp_cap, ...))
// tiers, counted in counts[0] and counts[1].
template <class Walk>
__global__ void __launch_bounds__(kThreads) rows_kernel(
    Walk walk, int64_t rows, float* __restrict__ out, int64_t ldo,
    int32_t* __restrict__ lists, int64_t warp_cap,
    int32_t* __restrict__ counts) {
  constexpr int C = Walk::kC;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const bool valid = r < rows;
  const int64_t n = valid ? walk.length(r) : 0;
  if (valid && n <= Walk::kThreadWalk) {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    walk.sum(r, 0, 1, acc);
    store_row<C>(acc, out, ldo, r);
  }
  append(lists, counts, valid && n > Walk::kThreadWalk &&
                            n <= Walk::kWarpWalk, r);
  append(lists + warp_cap, counts + 1, valid && n > Walk::kWarpWalk, r);
}

// Second pass: each block takes listed block-tier rows (block-strided), then
// each warp listed warp-tier rows (warp-strided).
template <class Walk>
__global__ void __launch_bounds__(kThreads) tier_kernel(
    Walk walk, float* __restrict__ out, int64_t ldo,
    const int32_t* __restrict__ lists, int64_t warp_cap,
    const int32_t* __restrict__ counts) {
  constexpr int C = Walk::kC;
  __shared__ float red[kThreads / 32 * C];
  const int blocks = *(counts + 1);
  for (int i = blockIdx.x; i < blocks; i += gridDim.x) {
    const int64_t r = lists[warp_cap + i];
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    walk.sum(r, threadIdx.x, kThreads, acc);
    block_reduce<C>(acc, red);
    if (threadIdx.x == 0) store_row<C>(acc, out, ldo, r);
  }
  const int warps = *counts;
  const int lane = threadIdx.x & 31;
  const int per_block = kThreads / 32;
  for (int i = blockIdx.x * per_block + (threadIdx.x >> 5); i < warps;
       i += gridDim.x * per_block) {
    const int64_t r = lists[i];
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    walk.sum(r, lane, 32, acc);
    warp_reduce<C>(acc);
    if (lane == 0) store_row<C>(acc, out, ldo, r);
  }
}

template <class Walk>
int launch_walk(const Walk& walk, int64_t rows, float* out, int64_t ldo,
                int32_t* lists, int64_t warp_cap, int32_t* counts,
                cudaStream_t stream) {
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  rows_kernel<Walk><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      walk, rows, out, ldo, lists, warp_cap, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tier_kernel<Walk><<<kLongBlocks, kThreads, 0, stream>>>(
      walk, out, ldo, lists, warp_cap, counts);
  return static_cast<int>(cudaGetLastError());
}

// ---- passes before the walks ---------------------------------------------

__global__ void __launch_bounds__(kThreads) run_starts_kernel(
    const int32_t* __restrict__ keys, int64_t m, int64_t rows,
    int32_t* __restrict__ starts) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  // Position p starts the rows (prev, cur]: those above the key before it
  // up to its own.  Keys are clamped to [-1, rows], which is
  // searchsorted's answer for keys outside [0, rows).
  long long prev = rows, cur = rows;
  if (p <= m) {
    const long long lo = -1, hi = rows;
    prev = p == 0 ? lo : min(max(static_cast<long long>(__ldg(keys + p - 1)),
                                 lo), hi);
    cur = p == m ? hi : min(max(static_cast<long long>(__ldg(keys + p)), lo),
                            hi);
  }
  const bool big = cur - prev > kGapInline;
  if (!big) {
    for (long long r = prev + 1; r <= cur; ++r) {
      starts[r] = static_cast<int32_t>(p);
    }
  }
  // A long gap (rows no key reaches) is filled by the whole warp.
  unsigned mask = __ballot_sync(0xffffffffu, big);
  const int lane = threadIdx.x & 31;
  while (mask != 0) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const long long bp = __shfl_sync(0xffffffffu, static_cast<long long>(p),
                                     src);
    const long long bprev = __shfl_sync(0xffffffffu, prev, src);
    const long long bcur = __shfl_sync(0xffffffffu, cur, src);
    for (long long r = bprev + 1 + lane; r <= bcur; r += 32) {
      starts[r] = static_cast<int32_t>(bp);
    }
  }
}

// [L, C, n] grads (level stride ldl, channel stride ldc, samples contiguous)
// -> rows [L n, C].
template <int C>
__global__ void __launch_bounds__(kThreads) interleave_grads_kernel(
    const float* __restrict__ g, int64_t ldl, int64_t ldc, int64_t n,
    int64_t total, float* __restrict__ rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= total) return;
  const int64_t l = i / n;
  const float* src = g + l * ldl + (i - l * n);
  float v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = __ldg(src + c * ldc);
  store_vec<C>(rows + i * C, v);
}

// K2 pass A: the records of the M dense samples in sample order.
template <int C>
__global__ void __launch_bounds__(kThreads) dense_pack_kernel(
    const float* __restrict__ g, int64_t ldg, const float* __restrict__ fr,
    int64_t ldf, int64_t m, float* __restrict__ tmp) {
  constexpr int kRec = record_floats<C>();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= m) return;
  float v[kRec];
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = __ldg(g + c * ldg + i);
#pragma unroll
  for (int d = 0; d < 3; ++d) v[C + d] = bf16_round(__ldg(fr + d * ldf + i));
#pragma unroll
  for (int e = C + 3; e < kRec; ++e) v[e] = 0.0f;
  store_vec<kRec>(tmp + i * kRec, v);
}

// K2 pass B: rec[p] = tmp[perm[p]].
template <int kRec>
__global__ void __launch_bounds__(kThreads) gather_records_kernel(
    const float* __restrict__ tmp, const int64_t* __restrict__ perm,
    int64_t m, float* __restrict__ rec) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= m) return;
  float v[kRec];
  load_row<kRec>(tmp + load_col(perm + p) * kRec, v);
  store_vec<kRec>(rec + p * kRec, v);
}

// K3's fused entry, first pass: a thread per sample (l, s) of the [L, C, n]
// grads (level stride ldl, channel stride ldc) reads its C grads once and
// writes the records of its 8 corner columns col = (l * 8 + k) * n + s: word
// j holds bf16(w[col] * g[l, 2j, s]) in its low half and bf16(w[col] *
// g[l, 2j + 1, s]) in its high half, each product rounded to f32 first
// (__fmul_rn, torch's rounding) and then once to bf16.
template <int C>
__global__ void __launch_bounds__(kThreads) form_records_kernel(
    const float* __restrict__ g, int64_t ldl, int64_t ldc,
    const float* __restrict__ w, int64_t n, int64_t total,
    float* __restrict__ rec) {
  constexpr int kW = C / 2;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= total) return;
  const int64_t l = i / n;
  const int64_t s = i - l * n;
  float gv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gv[c] = __ldg(g + l * ldl + c * ldc + s);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t col = (l * 8 + k) * n + s;
    const float wk = __ldg(w + col);
    float word[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      word[j] = __uint_as_float(bf16_bits(__fmul_rn(wk, gv[2 * j])) |
                                (bf16_bits(__fmul_rn(wk, gv[2 * j + 1]))
                                 << 16));
    }
    store_vec<kW>(rec + col * kW, word);
  }
}

unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// Calls f with std::integral_constant<int, C> for the channel counts the
// kernels take.
template <class F>
int with_channels(int channels, F&& f) {
  switch (channels) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Arguments common to the walks.  perm: int64 [M], sorted position ->
// column.  starts: int32 [rows + 1], the run of row r is sorted positions
// [starts[r], starts[r + 1]).  out: C planes of `rows` floats at out + c *
// ldo; every row is written.  lists: int32 scratch, warp_cap entries for the
// warp tier and then room for the block tier (the wrapper sizes both from
// the total walk and the tier limits); counts: two int32, zeroed by the
// caller.  Each returns cudaGetLastError() after its launches.

// Run starts.  keys: the stable sort's int32 [M] keys; starts: int32
// [rows + 1], every entry written.
extern "C" int ucnerf_run_starts(const void* keys, long long m,
                                 long long rows, void* starts, void* stream) {
  run_starts_kernel<<<grid_for(m + 1), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), m, rows,
      static_cast<int32_t*>(starts));
  return static_cast<int>(cudaGetLastError());
}

// K1.  values: C planes of M floats, plane c at values + c * ldv.
extern "C" int ucnerf_segment_sum_cm(const void* values, long long ldv,
                                     const void* perm, const void* starts,
                                     long long rows, void* out, long long ldo,
                                     int channels, void* lists,
                                     long long warp_cap, void* counts,
                                     void* stream) {
  if (rows <= 0) return 0;
  return with_channels(channels, [&](auto cc) {
    constexpr int C = decltype(cc)::value;
    RunWalk<C, F32Planes<C>, kRowUnroll> walk{
        F32Planes<C>{static_cast<const float*>(values), ldv},
        static_cast<const int64_t*>(perm), static_cast<const int32_t*>(starts)};
    return launch_walk(walk, rows, static_cast<float*>(out), ldo,
                       static_cast<int32_t*>(lists), warp_cap,
                       static_cast<int32_t*>(counts),
                       static_cast<cudaStream_t>(stream));
  });
}

// K1, fused entry.  g: [L, C, n] f32, level stride ldl and channel stride
// ldc (samples contiguous); w: [L, 8, n] f32, contiguous.  The column of an
// update is (l * 8 + k) * n + s.  grads: f32 scratch of L * n * C floats for
// the interleaved grads.
extern "C" int ucnerf_wsum_sum_cm(const void* g, long long ldl, long long ldc,
                                  const void* w, long long n, long long levels,
                                  const void* perm, const void* starts,
                                  long long rows, void* out, long long ldo,
                                  int channels, void* grads, void* lists,
                                  long long warp_cap, void* counts,
                                  void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_channels(channels, [&](auto cc) {
    constexpr int C = decltype(cc)::value;
    float* rows_g = static_cast<float*>(grads);
    if (levels * n > 0) {
      interleave_grads_kernel<C><<<grid_for(levels * n), kThreads, 0, st>>>(
          static_cast<const float*>(g), ldl, ldc, n, levels * n, rows_g);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    auto run = [&](auto unroll) {
      RunWalk<C, WeightedRows<C>, decltype(unroll)::value> walk{
          WeightedRows<C>{static_cast<const float*>(w), rows_g, n},
          static_cast<const int64_t*>(perm),
          static_cast<const int32_t*>(starts)};
      return launch_walk(walk, rows, static_cast<float*>(out), ldo,
                         static_cast<int32_t*>(lists), warp_cap,
                         static_cast<int32_t*>(counts), st);
    };
    // Rows of about one update (the NeRF grid's 1.1 on average) run faster
    // with 4 loads in flight and the registers that frees for more threads;
    // longer walks (the proposal grid's 4.4) with 8.  The order of the sum
    // is the same either way.
    if (levels * 8 * n >= 2 * rows) {
      return run(std::integral_constant<int, kRowUnroll>{});
    }
    return run(std::integral_constant<int, kRowUnroll / 2>{});
  });
}

// K2.  g: C planes of m floats (ldg); fr: 3 planes of m floats (ldf), the
// fractional coords (rounded to bf16 here).  perm/starts: the base keys'
// sorted order and runs over [0, rows].  level_offsets (host, nlevels + 1
// entries, the last == rows) and strides (host, nlevels entries) describe the
// dense levels; every sample of level l has its 8 corners inside
// [offset[l], offset[l + 1]).  tmp, rec: f32 scratch of m * R floats each,
// R = the record's floats (8 at C = 4; record_floats).
extern "C" int ucnerf_dense_sum_cm(const void* g, long long ldg,
                                   const void* fr, long long ldf, long long m,
                                   const void* perm, const void* starts,
                                   long long rows,
                                   const long long* level_offsets,
                                   const long long* strides, int nlevels,
                                   void* out, long long ldo, int channels,
                                   void* tmp, void* rec, void* lists,
                                   long long warp_cap, void* counts,
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_channels(channels, [&](auto cc) {
    constexpr int C = decltype(cc)::value;
    constexpr int kRec = record_floats<C>();
    float* rec_f = static_cast<float*>(rec);
    if (m > 0) {
      float* tmp_f = static_cast<float*>(tmp);
      dense_pack_kernel<C><<<grid_for(m), kThreads, 0, st>>>(
          static_cast<const float*>(g), ldg, static_cast<const float*>(fr),
          ldf, m, tmp_f);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      gather_records_kernel<kRec><<<grid_for(m), kThreads, 0, st>>>(
          tmp_f, static_cast<const int64_t*>(perm), m, rec_f);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    DenseWalk<C> walk{rec_f, static_cast<const int32_t*>(starts), lv};
    return launch_walk(walk, rows, static_cast<float*>(out), ldo,
                       static_cast<int32_t*>(lists), warp_cap,
                       static_cast<int32_t*>(counts), st);
  });
}

// K3.  packed: channels / 2 planes of M 32-bit words (bf16 pairs, see above),
// plane c at packed + c * ldp words.  channels (even) counts the f32 output
// planes.  Other arguments as for K1.
extern "C" int ucnerf_packed_sum_cm(const void* packed, long long ldp,
                                    const void* perm, const void* starts,
                                    long long rows, void* out, long long ldo,
                                    int channels, void* lists,
                                    long long warp_cap, void* counts,
                                    void* stream) {
  if (rows <= 0) return 0;
  return with_channels(channels, [&](auto cc) {
    constexpr int C = decltype(cc)::value;
    // Bf16 pairs need an even channel count.
    if constexpr (C % 2 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      RunWalk<C, Bf16Pairs<C>, kRowUnroll> walk{
          Bf16Pairs<C>{static_cast<const uint32_t*>(packed), ldp},
          static_cast<const int64_t*>(perm),
          static_cast<const int32_t*>(starts)};
      return launch_walk(walk, rows, static_cast<float*>(out), ldo,
                         static_cast<int32_t*>(lists), warp_cap,
                         static_cast<int32_t*>(counts),
                         static_cast<cudaStream_t>(stream));
    }
  });
}

// K3, fused entry.  g, w, n, levels as for K1's fused entry; channels (2, 4
// or 8) counts the f32 output planes.  records: scratch of levels * 8 * n *
// channels / 2 words, the records in column order.  Other arguments as for
// K1.
extern "C" int ucnerf_wsum_packed_sum_cm(
    const void* g, long long ldl, long long ldc, const void* w, long long n,
    long long levels, const void* perm, const void* starts, long long rows,
    void* out, long long ldo, int channels, void* records, void* lists,
    long long warp_cap, void* counts, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_channels(channels, [&](auto cc) {
    constexpr int C = decltype(cc)::value;
    if constexpr (C % 2 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      float* rec = static_cast<float*>(records);
      if (levels * n > 0) {
        form_records_kernel<C><<<grid_for(levels * n), kThreads, 0, st>>>(
            static_cast<const float*>(g), ldl, ldc,
            static_cast<const float*>(w), n, levels * n, rec);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      RunWalk<C, Bf16Records<C>, kRowUnroll> walk{
          Bf16Records<C>{rec}, static_cast<const int64_t*>(perm),
          static_cast<const int32_t*>(starts)};
      return launch_walk(walk, rows, static_cast<float*>(out), ldo,
                         static_cast<int32_t*>(lists), warp_cap,
                         static_cast<int32_t*>(counts), st);
    }
  });
}
