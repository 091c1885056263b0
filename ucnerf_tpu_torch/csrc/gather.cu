// Forward hash-grid lookup for Hopper (sm_90a), two entry points over one load
// path:
//
//   take_cm       out[c, i] = table[c, idx[i]]            (0 for a sentinel)
//   take_wsum_cm  out[c, n] = sum over the 8 corners k, in corner order, of
//                             w[k, n] * table[c, idx[k, n]]
//
// a sentinel being an index outside [0, rows); optionally each table value is
// rounded to bf16 (nearest-even) and widened back before it is used.
//
// They replace the TPU Pallas kernel ucnerf_tpu/ops/gather.py::gather_sorted_cm
// (pallas_call at gather.py:172, wrapped by take_cm at gather.py:184) and, for
// take_wsum_cm, the weighted corner sum that follows it in the encoder.  The
// Pallas kernel sorts the indices, walks table windows with a one-hot MXU
// contraction and sorts the result back, because a TPU gather reads a whole
// (8, 128) tile per index.  Hopper loads words directly, so the indices stay
// in their original order.
//
// What bounds it: not DRAM but L2 sectors.  A hashed level's slice (2^21 rows
// * 16 B = 32 MB) fits the H100's 50 MB L2, so the random loads are served
// from L2; but the table is channel-major ([C, rows], planes 8 MB apart), and
// a 4-byte load from each of 4 planes moves four 32-byte sectors for 16
// useful bytes.  So the level is first copied into a row-interleaved
// [rows, C] image (interleave_kernel: the slice read once and written once,
// 64 MB at 2^21 rows), and each index then costs ONE 16-byte load, one
// sector.  The index and weight streams are read with streaming loads and the
// output written with streaming stores (evict-first), so that they do not
// push the image out of L2.  Each thread takes 4 neighbouring indices (one
// 16-byte index load, four 16-byte table loads in flight, one 16-byte store
// per channel); a stream whose length or alignment does not allow that, and
// any C other than 4, takes the one-index-per-thread path of the same
// templates.
//
// take_wsum_cm keeps the 8 gathered rows of a point in registers, multiplies
// by the weights and adds them in corner order (separately rounded f32
// multiply and add, as the plain version does), and writes C values per
// POINT: the [C, 8, N] gathered tensor, its product with the weights and the
// reduction pass never reach device memory.
//
// Bound (bytes, at 3.35 TB/s; each input read and each output written once):
// take_cm: M * (4 B index + 4*C B output) + the touched table rows; at a
// proposal level of a 15000-ray chunk (M = 92.2 M) 1.88 GB, 0.56 ms; a NeRF
// level (M = 23.0 M) 0.14 ms.  take_wsum_cm: N * (8 * (4 + 4) B + 4*C B) +
// the table rows; at N = 11.52 M points 0.95 GB, 0.28 ms.
//
// Offsets are 64-bit: at M = 92 M and C = 4, c * M + i passes 2^31.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCorners = 8;
// Grid-stride loops: enough blocks to fill 132 SMs many times over.
constexpr int64_t kMaxBlocks = 132 * 32;

int grid_for(int64_t items) {
  const int64_t want = (items + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

// image[r, c] = table[c, r]: the channel-major slice as rows of C floats.
template <int C>
__global__ void __launch_bounds__(kThreads) interleave_kernel(
    const float* __restrict__ table, int64_t ld, int64_t rows,
    float* __restrict__ image, int channels) {
  const int nc = C > 0 ? C : channels;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < rows; r += step) {
    if (C == 4) {
      float4 v;
      v.x = __ldg(table + r);
      v.y = __ldg(table + ld + r);
      v.z = __ldg(table + 2 * ld + r);
      v.w = __ldg(table + 3 * ld + r);
      reinterpret_cast<float4*>(image)[r] = v;
    } else {
      for (int c = 0; c < nc; ++c) image[r * nc + c] = __ldg(table + c * ld + r);
    }
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The C values of row r of the image, 0 for a sentinel.  C = 4: one 16-byte
// load (the image is 16-byte aligned: the caller allocates it).
template <int C, bool kBf16>
__device__ __forceinline__ void load_row(const float* __restrict__ image,
                                         int64_t rows, int32_t r, int nc,
                                         float* v) {
  const bool valid = r >= 0 && static_cast<int64_t>(r) < rows;
  if (C == 4) {
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (valid) x = __ldg(reinterpret_cast<const float4*>(image) + r);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    for (int c = 0; c < nc; ++c) {
      v[c] = valid ? __ldg(image + static_cast<int64_t>(r) * nc + c) : 0.0f;
    }
  }
  if (kBf16) {
    const int n = C > 0 ? C : nc;
#pragma unroll
    for (int c = 0; c < n; ++c) v[c] = round_bf16(v[c]);
  }
}

// V neighbouring elements of a stream, read once (evict-first).  V = 4 needs
// p 16-byte aligned.
template <int V>
__device__ __forceinline__ void load_stream(const int32_t* __restrict__ p,
                                            int32_t* x) {
  if (V == 4) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    x[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void load_stream(const float* __restrict__ p,
                                            float* x) {
  if (V == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    x[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void store_stream(float* __restrict__ p,
                                             const float* x) {
  if (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else {
    __stcs(p, x[0]);
  }
}

// C = 0: any channel count, one index per thread (V = 1).
constexpr int kMaxChannels = 16;

template <int C, int V, bool kBf16>
__global__ void __launch_bounds__(kThreads) take_kernel(
    const float* __restrict__ image, int64_t rows,
    const int32_t* __restrict__ idx, int64_t m, float* __restrict__ out,
    int channels) {
  constexpr int kC = C > 0 ? C : kMaxChannels;
  const int nc = C > 0 ? C : channels;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x * V;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * V;
       i < m; i += step) {
    int32_t r[V];
    load_stream<V>(idx + i, r);
    float v[V][kC];
#pragma unroll
    for (int u = 0; u < V; ++u) load_row<C, kBf16>(image, rows, r[u], nc, v[u]);
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      float x[V];
#pragma unroll
      for (int u = 0; u < V; ++u) x[u] = v[u][c];
      store_stream<V>(out + c * m + i, x);
    }
  }
}

template <int C, int V, bool kBf16>
__global__ void __launch_bounds__(kThreads) take_wsum_kernel(
    const float* __restrict__ image, int64_t rows,
    const int32_t* __restrict__ idx, const float* __restrict__ w, int64_t n,
    float* __restrict__ out, int channels) {
  constexpr int kC = C > 0 ? C : kMaxChannels;
  const int nc = C > 0 ? C : channels;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x * V;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * V;
       i < n; i += step) {
    float acc[V][kC];
#pragma unroll
    for (int u = 0; u < V; ++u) {
#pragma unroll
      for (int c = 0; c < nc; ++c) acc[u][c] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kCorners; ++k) {
      int32_t r[V];
      float wk[V];
      load_stream<V>(idx + k * n + i, r);
      load_stream<V>(w + k * n + i, wk);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        float row[kC];
        load_row<C, kBf16>(image, rows, r[u], nc, row);
        // Product and sum rounded separately (no fused multiply-add), in
        // corner order, as the plain version forms them.
#pragma unroll
        for (int c = 0; c < nc; ++c) {
          acc[u][c] = __fadd_rn(acc[u][c], __fmul_rn(wk[u], row[c]));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < nc; ++c) {
      float x[V];
#pragma unroll
      for (int u = 0; u < V; ++u) x[u] = acc[u][c];
      store_stream<V>(out + c * n + i, x);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int C, int V>
void launch_take(const float* image, int64_t rows, const int32_t* idx,
                 const float* w, int64_t m, float* out, int channels,
                 bool bf16, cudaStream_t stream) {
  const int blocks = grid_for((m + V - 1) / V);
  if (w == nullptr) {
    if (bf16) {
      take_kernel<C, V, true><<<blocks, kThreads, 0, stream>>>(
          image, rows, idx, m, out, channels);
    } else {
      take_kernel<C, V, false><<<blocks, kThreads, 0, stream>>>(
          image, rows, idx, m, out, channels);
    }
  } else if (bf16) {
    take_wsum_kernel<C, V, true><<<blocks, kThreads, 0, stream>>>(
        image, rows, idx, w, m, out, channels);
  } else {
    take_wsum_kernel<C, V, false><<<blocks, kThreads, 0, stream>>>(
        image, rows, idx, w, m, out, channels);
  }
}

int interleave(const float* table, int64_t ld, int64_t rows, float* image,
               int channels, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (channels == 4) {
    interleave_kernel<4><<<grid_for(rows), kThreads, 0, stream>>>(
        table, ld, rows, image, channels);
  } else {
    interleave_kernel<0><<<grid_for(rows), kThreads, 0, stream>>>(
        table, ld, rows, image, channels);
  }
  return static_cast<int>(cudaGetLastError());
}

// Copies the slice into `image`, then gathers from it: take_cm when w is null
// (m indices), else take_wsum_cm (m points, idx and w [8, m]).
int run(const float* table, int64_t ld, int64_t rows, const int32_t* idx,
        const float* w, int64_t m, float* out, float* image, int channels,
        bool bf16, cudaStream_t stream) {
  if (channels < 1 || channels > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m <= 0) return 0;
  const int err = interleave(table, ld, rows, image, channels, stream);
  if (err != 0) return err;
  // Four indices per thread when every 16-byte access is aligned: the
  // streams' starts, and each corner row and output plane (m % 4 == 0).
  const bool vec = channels == 4 && m % 4 == 0 && aligned16(idx) &&
                   aligned16(out) && aligned16(w);
  if (channels != 4) {
    launch_take<0, 1>(image, rows, idx, w, m, out, channels, bf16, stream);
  } else if (vec) {
    launch_take<4, 4>(image, rows, idx, w, m, out, channels, bf16, stream);
  } else {
    launch_take<4, 1>(image, rows, idx, w, m, out, channels, bf16, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: C channel planes of `rows` floats, plane c at table + c * ld.
// idx: m int32 row indices.  out: [C, m] float32, preallocated.
// image: scratch of rows * C floats, 16-byte aligned.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int ucnerf_take_cm(const void* table, long long ld, long long rows,
                              const void* idx, long long m, void* out,
                              void* image, int channels, int bf16,
                              void* stream) {
  return run(static_cast<const float*>(table), ld, rows,
             static_cast<const int32_t*>(idx), nullptr, m,
             static_cast<float*>(out), static_cast<float*>(image), channels,
             bf16 != 0, static_cast<cudaStream_t>(stream));
}

// As ucnerf_take_cm, with idx int32 [8, n] and w float32 [8, n] (corner-major,
// contiguous) and out [C, n].
extern "C" int ucnerf_take_wsum_cm(const void* table, long long ld,
                                   long long rows, const void* idx,
                                   const void* w, long long n, void* out,
                                   void* image, int channels, int bf16,
                                   void* stream) {
  if (w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(static_cast<const float*>(table), ld, rows,
             static_cast<const int32_t*>(idx), static_cast<const float*>(w), n,
             static_cast<float*>(out), static_cast<float*>(image), channels,
             bf16 != 0, static_cast<cudaStream_t>(stream));
}

// The interleave alone (what it costs inside the two calls above).
extern "C" int ucnerf_interleave_cm(const void* table, long long ld,
                                    long long rows, void* image, int channels,
                                    void* stream) {
  if (channels < 1 || channels > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return interleave(static_cast<const float*>(table), ld, rows,
                    static_cast<float*>(image), channels,
                    static_cast<cudaStream_t>(stream));
}
